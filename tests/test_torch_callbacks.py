"""horovod_tpu_torch's training callbacks (``callbacks.py``) against the JAX
package's.

The seven callback tests of ``tests/test_callbacks_syncbn.py`` (:94-224)
run here on the port with the same assertions; where the reference drives
a jitted optax step through ``scaled_lr``'s state node, the port drives a
torch optimizer whose ``param_groups`` ``set_lr_scale`` moves, with the
same SGD deltas: [1.0, 0.1, 0.01] under the schedule and [0.25, 0.625,
1.0] under the warm-up. Beside them: every warm-up and schedule multiplier
equals the reference's for the same arguments (staircase and per batch);
``set_lr_scale`` reaches the optimizer that steps bare, under
``DistributedOptimizer`` and under ZeRO-1 (``sharded=True``), sets a
tensor lr in place, and leaves an armed step replay armed (the replayed
steps go on, no invalidation); ``MetricAverageCallback`` gives the mean at
np=2 on gloo; ``CommitStateCallback`` commits an elastic ``TPUState``
every ``batches_per_commit`` batches; every name of the reference's
``__all__`` exists here. SGD updates of 1.0 x lr on fp32 are compared
within 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from horovod_tpu import callbacks as ref_cb

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks as cb
from horovod_tpu_torch.callbacks import (BestModelCheckpoint,
                                         BroadcastGlobalVariablesCallback,
                                         CallbackList,
                                         LearningRateScheduleCallback,
                                         LearningRateWarmupCallback,
                                         MetricAverageCallback,
                                         TrainLoopState)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def world(monkeypatch):
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# the reference's TestCallbacks and TestScaledLRUnderJit, on the port
# ---------------------------------------------------------------------------

class TestCallbacks:
    def test_lr_warmup_ramp(self):
        cbk = LearningRateWarmupCallback(warmup_epochs=4, size=8)
        state = TrainLoopState()
        scales = []
        for epoch in range(6):
            state.epoch = epoch
            cbk.on_epoch_begin(state)
            scales.append(state.lr_scale)
        assert scales[0] == pytest.approx(1.0 / 8)
        assert scales[4] == pytest.approx(1.0)
        assert all(b >= a for a, b in zip(scales, scales[1:]))

    def test_lr_schedule_staircase(self):
        cbk = LearningRateScheduleCallback(
            multiplier=lambda e: 0.1 ** (e // 2), start_epoch=0)
        state = TrainLoopState()
        state.epoch = 3
        cbk.on_epoch_begin(state)
        assert state.lr_scale == pytest.approx(0.1)

    def test_metric_average_single_rank(self):
        cbk = MetricAverageCallback()
        logs = {"loss": 2.0}
        cbk.on_epoch_end(TrainLoopState(), logs)
        assert logs["loss"] == 2.0

    def test_broadcast_and_checkpoint(self, tmp_path):
        params = {"w": torch.full((3,), 2.0)}
        state = TrainLoopState(params=params)
        CallbackList([BroadcastGlobalVariablesCallback(0)]) \
            .on_train_begin(state)
        np.testing.assert_allclose(state.params["w"].numpy(), 2.0)

        ckpt = BestModelCheckpoint(str(tmp_path / "best.pt"),
                                   monitor="loss", mode="min")
        ckpt.on_epoch_end(state, {"loss": 1.0})
        ckpt.on_epoch_end(state, {"loss": 2.0})  # no improvement
        saved = torch.load(tmp_path / "best.pt", weights_only=True)
        assert saved["loss"] == 1.0
        assert saved["epoch"] == 0
        assert torch.equal(saved["params"]["w"], params["w"])


def _sgd_step(opt, w, grad=1.0):
    """One step of ``opt`` on the scalar parameter ``w`` with gradient
    ``grad``; returns how far ``w`` moved down."""
    before = float(w.detach())
    opt.zero_grad()
    (w * grad).sum().backward()
    opt.step()
    return before - float(w.detach())


class TestScaledLR:
    """The LR schedule/warmup callbacks move the lr the stepping optimizer
    reads (the reference's jitted-step cases)."""

    def test_scale_changes_updates(self):
        w = torch.nn.Parameter(torch.ones(3))
        opt = cb.scaled_lr(torch.optim.SGD([w], lr=1.0))
        opt.zero_grad()
        w.sum().backward()
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), 0.0, atol=1e-6)
        # halve the LR via the setter: the next step takes it
        assert cb.set_lr_scale(opt, 0.5) is opt
        opt.zero_grad()
        w.sum().backward()
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), -0.5, atol=1e-6)
        assert getattr(opt, cb._LR_ATTR) == cb.ScaledLRState((1.0,), 0.5)

    def test_schedule_callback_drives_step(self):
        w = torch.nn.Parameter(torch.zeros(()))
        opt = cb.scaled_lr(torch.optim.SGD([w], lr=1.0))
        state = cb.TrainLoopState(params={"w": w}, opt_state=opt)
        sched = cb.LearningRateScheduleCallback(
            multiplier=lambda epoch: 10.0 ** -epoch)
        deltas = []
        for epoch in range(3):
            state.epoch = epoch
            sched.on_epoch_begin(state)
            deltas.append(_sgd_step(state.opt_state, w))
        np.testing.assert_allclose(deltas, [1.0, 0.1, 0.01], rtol=1e-5)

    def test_warmup_callback_ramps(self):
        w = torch.nn.Parameter(torch.zeros(()))
        opt = cb.scaled_lr(torch.optim.SGD([w], lr=1.0))
        state = cb.TrainLoopState(params={"w": w}, opt_state=opt)
        warm = cb.LearningRateWarmupCallback(warmup_epochs=2.0, size=4)
        scales = []
        for epoch in range(3):
            state.epoch = epoch
            warm.on_epoch_begin(state)
            scales.append(round(_sgd_step(state.opt_state, w), 5))
        # epoch 0: 1/4; epoch 1: (1/4)(1*3/2+1)=0.625; epoch 2: full 1.0
        np.testing.assert_allclose(scales, [0.25, 0.625, 1.0], rtol=1e-4)


# ---------------------------------------------------------------------------
# the port against the reference, and what the port adds
# ---------------------------------------------------------------------------

def test_every_reference_name_exists():
    assert set(ref_cb.__all__) <= set(cb.__all__)
    for name in ref_cb.__all__:
        assert hasattr(cb, name), name


WARMUPS = [dict(warmup_epochs=w, size=s, steps_per_epoch=spe)
           for w in (0.0, 1.0, 2.5, 5.0) for s in (1, 4, 8)
           for spe in (None, 3)]


@pytest.mark.parametrize("kw", WARMUPS,
                         ids=lambda kw: "w{warmup_epochs}-s{size}-"
                                        "spe{steps_per_epoch}".format(**kw))
def test_warmup_multipliers_are_the_references(kw):
    """The lr_scale after each epoch's and each batch's hook, 7 epochs of
    3 batches, the same in both packages."""
    def trail(mod, c):
        state = mod.TrainLoopState()
        out = []
        for epoch in range(7):
            state.epoch = epoch
            c.on_epoch_begin(state)
            for batch in range(3):
                c.on_batch_begin(state, batch)
                out.append(state.lr_scale)
        return out
    assert trail(cb, cb.LearningRateWarmupCallback(**kw)) == \
        trail(ref_cb, ref_cb.LearningRateWarmupCallback(**kw))


SCHEDULES = [dict(multiplier=lambda e: 0.1 ** (e // 2)),
             dict(multiplier=0.5, start_epoch=2, end_epoch=5),
             dict(multiplier=lambda e: 1.0 / (1.0 + e), staircase=False,
                  steps_per_epoch=4),
             dict(multiplier=lambda e: 0.9 ** e, start_epoch=1,
                  staircase=False, steps_per_epoch=3)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=range(len(SCHEDULES)))
def test_schedule_multipliers_are_the_references(kw):
    def trail(mod):
        c = mod.LearningRateScheduleCallback(**kw)
        state = mod.TrainLoopState()
        out = []
        for epoch in range(6):
            state.epoch = epoch
            c.on_epoch_begin(state)
            for batch in range(4):
                c.on_batch_begin(state, batch)
                out.append(state.lr_scale)
        return out
    assert trail(cb) == trail(ref_cb)


def _model():
    torch.manual_seed(0)
    return torch.nn.Linear(4, 2)


@pytest.mark.parametrize("form", ["bare", "distributed", "sharded"])
def test_set_lr_scale_reaches_the_stepping_optimizer(form):
    """SGD's update is lr x grad: after set_lr_scale(s) a step moves the
    parameters by base lr x s x grad, through each wrapper."""
    model = _model()
    inner = torch.optim.SGD(model.parameters(), lr=0.5)
    opt = {"bare": lambda o: o,
           "distributed": lambda o: hvd.DistributedOptimizer(o),
           "sharded": lambda o: hvd.DistributedOptimizer(o, sharded=True)
           }[form](cb.scaled_lr(inner))
    x = torch.ones(3, 4)
    for scale in (1.0, 0.25, 2.0):
        cb.set_lr_scale(opt, scale)
        assert [g["lr"] for g in inner.param_groups] == [0.5 * scale]
        before = [p.detach().clone() for p in model.parameters()]
        opt.zero_grad()
        model(x).sum().backward()
        grads = [p.grad.detach().clone() for p in model.parameters()]
        opt.step()
        for p, b, g in zip(model.parameters(), before, grads):
            np.testing.assert_allclose((b - p.detach()).numpy(),
                                       (0.5 * scale * g).numpy(),
                                       rtol=1e-6, atol=1e-6)


def test_set_lr_scale_sets_a_tensor_lr_in_place():
    model = _model()
    lr = torch.tensor(0.2)
    opt = cb.scaled_lr(torch.optim.Adam(model.parameters(), lr=lr))
    cb.set_lr_scale(opt, 0.5)
    assert opt.param_groups[0]["lr"] is lr
    assert float(lr) == pytest.approx(0.1)
    with pytest.raises(ValueError, match="scaled_lr"):
        cb.set_lr_scale(torch.optim.SGD(model.parameters(), lr=0.1), 0.5)


def test_set_lr_scale_leaves_an_armed_replay_armed():
    """ZeRO-1 at size 1 brackets every step for step replay: after the
    warm-up the step replays; a new lr moves the update and the next steps
    go on replaying, with no fallback and no invalidation."""
    from horovod_tpu_torch.core.state import global_state
    eng = global_state().engine
    model = _model()
    inner = torch.optim.SGD(model.parameters(), lr=0.5)
    opt = hvd.DistributedOptimizer(cb.scaled_lr(inner), sharded=True)
    x = torch.ones(3, 4)
    rep = eng.replay
    warm = eng.config.step_replay_warmup
    for _ in range(warm + 1):
        opt.zero_grad()
        model(x).sum().backward()
        opt.step()
    replayed, fallbacks = rep.replayed_steps, rep.fallbacks
    assert replayed >= 1 and any(e.get("armed") for e in rep._seen.values())
    before = [p.detach().clone() for p in model.parameters()]
    cb.set_lr_scale(opt, 0.1)
    for _ in range(2):
        opt.zero_grad()
        model(x).sum().backward()
        opt.step()
    assert rep.replayed_steps == replayed + 2
    assert rep.fallbacks == fallbacks
    assert any(e.get("armed") for e in rep._seen.values())
    # the weight's gradient is x's column sums (3) for each output row:
    # two steps of 0.5 x 0.1 x 3
    w = model.weight.detach()
    np.testing.assert_allclose((before[0] - w).numpy(), 0.3, rtol=1e-5)


@pytest.mark.integration
def test_metric_average_np2_gives_the_mean():
    from horovod_tpu_torch.runner import run
    from torch_worker import metric_average_fn
    results = run(metric_average_fn, np=2, env={
        "HOROVOD_TPU_PLATFORM": "cpu",
        "HOROVOD_STALL_CHECK_DISABLE": "1",
        "PYTHONPATH": os.pathsep.join(
            [REPO, os.path.join(REPO, "tests"),
             os.environ.get("PYTHONPATH", "")])})
    assert results == [{"loss": 1.5, "acc": 0.125}] * 2


def test_commit_state_callback_commits_every_n_batches():
    from horovod_tpu_torch.elastic import TPUState
    model = _model()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    state = TPUState(params=model, opt_state=opt, batch=0)
    commits = []
    save = state.save
    state.save = lambda: (commits.append(state.batch), save())[1]
    c = cb.CommitStateCallback(state, batches_per_commit=3)
    loop = TrainLoopState(params=model, opt_state=opt)
    for batch in range(7):
        state.batch = batch
        c.on_batch_end(loop, batch)
    assert commits == [2, 5]


def test_best_model_checkpoint_writes_on_rank_0_only(tmp_path,
                                                      monkeypatch):
    model = _model()
    state = TrainLoopState(params=model, epoch=4)
    monkeypatch.setattr(hvd, "rank", lambda: 1)
    BestModelCheckpoint(str(tmp_path / "r1.pt")).on_epoch_end(
        state, {"val_loss": 0.5})
    assert not (tmp_path / "r1.pt").exists()
    monkeypatch.undo()
    ckpt = BestModelCheckpoint(str(tmp_path / "r0.pt"), mode="max",
                               monitor="acc")
    ckpt.on_epoch_end(state, {"acc": 0.5})
    state.epoch = 5
    ckpt.on_epoch_end(state, {"acc": 0.25})
    saved = torch.load(tmp_path / "r0.pt", weights_only=True)
    assert (saved["epoch"], saved["acc"]) == (4, 0.5)
    assert set(saved["params"]) == set(model.state_dict())
