"""horovod_tpu_torch's elastic state, run loop and notification channel
against the JAX package's (``tests/test_elastic_state.py``, case for case).

Both packages run in this process, each in its own world of one (the port
on gloo). The run loop's parity drives the reference's ``run_fn`` and the
port's through the same scripted failure sequence with a reset that
counts: restores, resets, syncs and the final object state must be equal.
``TPUState`` is the port's role of Horovod's ``TorchState``: a tiny LM and
AdamW, committed to host RAM and restored in place, bitwise; its values
agree with the reference's ``TPUState`` over the same weights (carried by
``transformer_from_jax``) within 1e-6 of each tensor's largest entry
(fp32; three AdamW steps of torch and optax agree to 1e-6,
``test_torch_transformer.py``). Its durable tier goes through the port's
``CheckpointManager``.
"""

import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import horovod_tpu as rhvd
import horovod_tpu_torch as hvd
from horovod_tpu.common.exceptions import HorovodInternalError as RInternal
from horovod_tpu.common.exceptions import HostsUpdatedInterrupt as RHosts
from horovod_tpu.elastic import ObjectState as RObjectState
from horovod_tpu.elastic import TPUState as RTPUState
from horovod_tpu.elastic import run_fn as r_run_fn
from horovod_tpu.models import transformer as JT
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 HostsUpdatedInterrupt)
from horovod_tpu_torch.elastic import (HostUpdateResult, ObjectState,
                                       TPUState, run_fn)
from horovod_tpu_torch.models.convert import transformer_from_jax
from horovod_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  lean_lm_loss)
from torch_worker import run_world

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=16)


@pytest.fixture(scope="module", autouse=True)
def init_hvd():
    rhvd.init()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _model(seed=0):
    cfg = TransformerConfig(dtype=torch.float32, attention="flash", **DIMS)
    return Transformer(cfg, generator=torch.Generator().manual_seed(seed))


def _tokens(seed=0):
    toks = np.random.RandomState(seed).randint(0, DIMS["vocab_size"],
                                               size=(2, DIMS["max_seq"] + 1))
    return torch.tensor(toks[:, :-1]), torch.tensor(toks[:, 1:])


def _adamw(model):
    # optax.adamw(3e-4)'s settings (PyTorch's weight decay default is 1e-2)
    return torch.optim.AdamW(model.parameters(), lr=3e-4,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _steps(model, opt, n, seed=0):
    x, y = _tokens(seed)
    losses = []
    for _ in range(n):
        opt.zero_grad()
        loss = lean_lm_loss(model, x, y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def _snapshot(model, opt) -> dict:
    """Every parameter and optimizer-state tensor, copied."""
    out = {f"p.{k}": v.detach().clone() for k, v in
           model.state_dict().items()}
    for i, st in opt.state_dict()["state"].items():
        out.update({f"o.{i}.{k}": v.clone() for k, v in st.items()})
    return out


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


class TestObjectState:
    def test_save_restore(self):
        state = ObjectState(batch=0, epoch=0)
        state.batch = 5
        state.commit()
        state.batch = 9
        state.restore()
        assert state.batch == 5 and state.epoch == 0

    def test_sync_noop_single(self):
        state = ObjectState(batch=3)
        state.sync()
        assert state.batch == 3

    def test_reset_callbacks(self):
        calls = []
        state = ObjectState(batch=0)
        state.register_reset_callbacks([lambda: calls.append(1)])
        state.on_reset()
        assert calls == [1]


class TestTPUState:
    def test_dict_save_restore(self):
        """The reference's pytree case on a dict of tensors: a rebound
        dict of the same layout is restored in place."""
        params = {"w": torch.ones(4, 4), "b": torch.zeros(4)}
        state = TPUState(params=params, batch=0)
        state.commit()
        state.params = {"w": torch.full((4, 4), 7.0), "b": torch.ones(4)}
        state.batch = 3
        state.restore()
        np.testing.assert_allclose(state.params["w"].numpy(), 1.0)
        np.testing.assert_allclose(state.params["b"].numpy(), 0.0)
        assert state.batch == 0

    def test_sync_broadcasts(self):
        params = {"w": torch.arange(4.0)}
        state = TPUState(params=params, step=2)
        state.sync()
        np.testing.assert_allclose(state.params["w"].numpy(), [0, 1, 2, 3])
        assert state.step == 2

    def test_host_update_interrupt_at_commit(self):
        state = ObjectState(batch=0)
        state.on_hosts_updated(int(time.time() * 1e6),
                               HostUpdateResult.ADDED)
        with pytest.raises(HostsUpdatedInterrupt) as ei:
            state.commit()
        assert ei.value.skip_sync  # additions only → state still valid
        # a mixed update does not skip sync
        state.on_hosts_updated(int(time.time() * 1e6) + 1,
                               HostUpdateResult.MIXED)
        with pytest.raises(HostsUpdatedInterrupt) as ei:
            state.commit()
        assert not ei.value.skip_sync

    @pytest.mark.parametrize("wrap", [False, True],
                             ids=["adamw", "distributed_optimizer"])
    def test_lm_save_mutate_restore_bitwise(self, wrap):
        """A tiny LM and AdamW: committed after 2 steps, 3 more steps move
        every tensor, restore() brings the commit back bitwise, in place
        (the optimizer still steps the model's own parameters), and the
        steps after it repeat the first run's losses bitwise."""
        model = _model()
        opt = _adamw(model)
        if wrap:
            opt = hvd.DistributedOptimizer(opt)
        _steps(model, opt, 2)
        state = TPUState(params=model, opt_state=opt, step=2)
        state.commit()
        want = _snapshot(model, opt)
        params = list(model.parameters())
        first = _steps(model, opt, 3)
        state.step = 5
        moved = _snapshot(model, opt)
        assert not torch.equal(moved["p.embed"], want["p.embed"])
        state.restore()
        assert state.step == 2
        _assert_bitwise(_snapshot(model, opt), want)
        assert all(a is b for a, b in
                   zip(params, opt.param_groups[0]["params"]))
        assert _steps(model, opt, 3) == first

    def test_restore_before_the_first_step(self):
        """Committed before the optimizer made its state: restore() takes
        the state back to none, as a fresh optimizer's."""
        model = _model(1)
        opt = _adamw(model)
        state = TPUState(params=model, opt_state=opt)
        state.commit()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        _steps(model, opt, 2)
        state.restore()
        assert not opt.state
        _assert_bitwise({k: v for k, v in model.state_dict().items()},
                        before)

    def test_save_reuses_its_host_buffers(self):
        model = _model(2)
        opt = _adamw(model)
        _steps(model, opt, 1)
        state = TPUState(params=model, opt_state=opt)
        held = state._saved_pytrees["params"]["embed"]
        _steps(model, opt, 1)
        state.commit()
        assert state._saved_pytrees["params"]["embed"] is held
        assert torch.equal(held, model.embed.detach())
        assert held.data_ptr() != model.embed.data_ptr()

    def test_committed_and_restored_values_agree_with_the_reference(self):
        """The same weights in both packages (the JAX tree through
        ``transformer_from_jax``), two AdamW steps (optax against torch),
        commit, one more step, restore: the reference's restored pytree
        and the port's restored model agree within 1e-6 of each tensor's
        largest entry, and so do their committed copies."""
        jcfg = JT.TransformerConfig(dtype=jnp.float32, attention="flash",
                                    **DIMS)
        rng = np.random.RandomState(4)
        params = jax.tree_util.tree_map(
            lambda a: (np.asarray(a) + 0.1 * rng.randn(*a.shape)).astype(
                np.float32),
            JT.init_params(jax.random.PRNGKey(0), jcfg))
        x, y = (t.numpy() for t in _tokens(4))
        grad_fn = jax.jit(jax.grad(JT.lean_lm_loss), static_argnums=3)
        tx = optax.adamw(3e-4)

        def ref_step(p, s):
            updates, s = tx.update(grad_fn(p, x, y, jcfg), s, p)
            return optax.apply_updates(p, updates), s

        p, s = params, tx.init(params)
        for _ in range(2):
            p, s = ref_step(p, s)
        ref = RTPUState(params=p, opt_state=s, step=2)
        ref.commit()
        ref.params, ref.opt_state = ref_step(ref.params, ref.opt_state)
        ref.restore()

        model = _model()
        cfg = TransformerConfig(dtype=torch.float32, attention="flash",
                                **DIMS)
        model.load_state_dict(transformer_from_jax(params, cfg))
        opt = _adamw(model)
        _steps(model, opt, 2, seed=4)
        state = TPUState(params=model, opt_state=opt, step=2)
        state.commit()
        _steps(model, opt, 1, seed=4)
        state.restore()

        want = transformer_from_jax(jax.device_get(ref.params), cfg)
        committed = state._saved_pytrees["params"]
        for name, got in model.state_dict().items():
            w = want[name].numpy()
            scale = max(float(np.abs(w).max()), 1e-6)
            assert np.abs(got.numpy() - w).max() <= 1e-6 * scale, name
            assert np.abs(committed[name].numpy() - w).max() <= \
                1e-6 * scale, name
        assert state.step == ref.step == 2


def _fake_state(base):
    class FakeState(base):
        def __init__(self):
            self.syncs = 0
            self.restores = 0
            super().__init__(batch=0)

        def sync(self):
            self.syncs += 1
            super().sync()

        def restore(self):
            self.restores += 1
            super().restore()
    return FakeState()


class TestRunLoop:
    def _state(self):
        return _fake_state(ObjectState)

    def test_returns_result(self):
        state = self._state()
        resets = []
        wrapped = run_fn(lambda s: "done", lambda: resets.append(1))
        assert wrapped(state) == "done"
        assert state.syncs == 1 and resets == []

    def test_internal_error_restores_and_retries(self):
        state = self._state()
        resets = []
        attempts = []

        def train(s):
            attempts.append(1)
            if len(attempts) == 1:
                raise HorovodInternalError("peer died")
            return "ok"

        wrapped = run_fn(train, lambda: resets.append(1))
        assert wrapped(state) == "ok"
        assert state.restores == 1
        assert len(resets) == 1
        assert state.syncs == 2  # initial + after restore

    def test_dist_error_restores_and_retries(self):
        """A peer crash that no engine wait saw surfaces as a raw
        torch.distributed error: restore + reset + retry, as the
        reference does for jax's runtime error."""
        state = self._state()
        resets = []
        attempts = []

        def train(s):
            attempts.append(1)
            if len(attempts) == 1:
                raise dist.DistBackendError("NCCL communicator was aborted")
            return "ok"

        wrapped = run_fn(train, lambda: resets.append(1))
        assert wrapped(state) == "ok"
        assert state.restores == 1
        assert len(resets) == 1

    def test_other_runtime_errors_propagate(self):
        """A RuntimeError that is no distributed error (a CUDA
        out-of-memory error, a bug) is not a peer's crash."""
        state = self._state()

        def train(s):
            raise RuntimeError("CUDA out of memory")

        with pytest.raises(RuntimeError, match="out of memory"):
            run_fn(train, lambda: None)(state)
        assert state.restores == 0

    def test_persistent_dist_error_escalates(self):
        import importlib
        run_mod = importlib.import_module("horovod_tpu_torch.elastic.run")
        state = self._state()
        attempts = []

        def train(s):
            attempts.append(1)
            raise dist.DistBackendError("deterministic failure")

        budget = run_mod._MAX_RUNTIME_ERROR_RETRIES
        wrapped = run_fn(train, lambda: None)
        with pytest.raises(dist.DistBackendError):
            wrapped(state)
        assert len(attempts) == budget + 1
        assert state.restores == budget

    def test_dist_error_retry_budget_resets_on_commit(self):
        import importlib
        run_mod = importlib.import_module("horovod_tpu_torch.elastic.run")
        state = self._state()
        attempts = []
        n_fail = run_mod._MAX_RUNTIME_ERROR_RETRIES * 2  # well past budget

        def train(s):
            attempts.append(1)
            if len(attempts) <= n_fail:
                state.commit()  # progress before every failure
                raise dist.DistBackendError("connection reset by peer")
            return "ok"

        wrapped = run_fn(train, lambda: None)
        assert wrapped(state) == "ok"
        assert state.restores == n_fail

    def test_hosts_updated_skips_sync_on_add(self):
        state = self._state()
        attempts = []

        def train(s):
            attempts.append(1)
            if len(attempts) == 1:
                raise HostsUpdatedInterrupt(skip_sync=True)
            return "ok"

        wrapped = run_fn(train, lambda: None)
        assert wrapped(state) == "ok"
        assert state.restores == 0
        assert state.syncs == 1  # skip_sync honored


# one scripted sequence of outcomes, one per attempt of the training
# function: the run loop's every branch, and a commit between raw errors
SCRIPT = ["internal", "raw", "raw", "commit+raw", "raw", "hosts_added",
          "commit+hosts_mixed", "raw", "internal", "ok"]
ESCALATE = ["commit+raw", "raw", "raw", "raw", "raw", "ok"]


def _drive(pkg: str, script):
    """Run ``script`` through one package's run_fn; returns what the run
    loop did and the final object state."""
    if pkg == "ref":
        base, run, internal, hosts = RObjectState, r_run_fn, RInternal, \
            RHosts
        raw = jax.errors.JaxRuntimeError
    else:
        base, run, internal, hosts = ObjectState, run_fn, \
            HorovodInternalError, HostsUpdatedInterrupt
        raw = dist.DistBackendError
    state = _fake_state(base)
    resets = []
    todo = list(script)

    def train(s):
        action = todo.pop(0)
        s.batch += 1
        if action.startswith("commit+"):
            s.commit()
            action = action[len("commit+"):]
        if action == "internal":
            raise internal("peer died")
        if action == "raw":
            raise raw("connection reset by peer")
        if action == "hosts_added":
            raise hosts(skip_sync=True)
        if action == "hosts_mixed":
            raise hosts(skip_sync=False)
        return ("ok", s.batch)

    try:
        out = run(train, lambda: resets.append(1))(state)
    except Exception as e:  # noqa: BLE001  the escalation
        out = ("raised", type(e).__name__ in ("JaxRuntimeError",
                                              "DistBackendError"))
    return dict(out=out, restores=state.restores, syncs=state.syncs,
                resets=len(resets), batch=state.batch, left=len(todo))


@pytest.mark.parametrize("script", [SCRIPT, ESCALATE],
                         ids=["recoveries", "escalation"])
def test_run_loop_matches_the_reference(script):
    got, want = _drive("port", script), _drive("ref", script)
    assert got == want
    assert got["restores"] > 0 and got["resets"] > 0


def test_real_reset_reinits_on_the_same_device_with_a_new_version(
        tmp_path, monkeypatch):
    """``@hvd.elastic.run`` with its own reset: a HorovodInternalError
    restores the commit, shuts the world down and inits it again on the
    CPU (not on a card), with a new engine and the world version one
    ahead (a world with no rendezvous numbers its own versions)."""
    model = _model(5)
    opt = _adamw(model)
    state = TPUState(params=model, opt_state=opt, step=0)
    engines, versions, devices = [], [], []

    @hvd.elastic.run
    def train(state):
        engines.append(hvd._engine())
        versions.append(hvd._engine().world_version)
        devices.append(hvd.device())
        while state.step < 4:
            _steps(model, opt, 1)
            state.step += 1
            if state.step == 2:
                state.commit()
            if state.step == 3 and len(engines) == 1:
                raise HorovodInternalError("injected")
        return state.step

    before = os.environ.get("HOROVOD_TPU_WORLD_VERSION")
    # the restore path's flight dump, and the new world's
    monkeypatch.setattr(hvd.global_state().config, "trace_dump_dir",
                        str(tmp_path))
    monkeypatch.setenv("HOROVOD_TPU_TRACE_DUMP_DIR", str(tmp_path))
    try:
        assert train(state) == 4
    finally:
        if before is None:
            os.environ.pop("HOROVOD_TPU_WORLD_VERSION", None)
        else:
            os.environ["HOROVOD_TPU_WORLD_VERSION"] = before
    assert len(engines) == 2 and engines[0] is not engines[1]
    assert versions[1] == versions[0] + 1
    assert devices == [torch.device("cpu")] * 2



def test_a_worker_removed_before_its_first_world(monkeypatch):
    """An elastic worker whose slot is removed before it joins a world
    keeps an inert, removed backend (rank 0 of 1, no engine) and
    ``@hvd.elastic.run`` returns None before any step (the reference's
    ``Backend.init``); after ``shutdown()`` the next ``init()`` asks the
    rendezvous again and joins the world it is then given."""
    from horovod_tpu_torch.runner.hosts import INVALID_SLOT_INFO, SlotInfo
    from horovod_tpu_torch.runner.http_server import KVStoreServer

    class Rendezvous(KVStoreServer):
        slot = INVALID_SLOT_INFO

        def handle_get(self, scope, key, handler):
            if scope == "rank_and_size":
                return ("1|" + self.slot.to_response_string()).encode()
            return super().handle_get(scope, key, handler)

    rdv = Rendezvous()
    rdv.start()
    hvd.shutdown()
    for knob, value in (("HOROVOD_ELASTIC", "1"),
                        ("HOROVOD_GLOO_RENDEZVOUS_ADDR", "127.0.0.1"),
                        ("HOROVOD_GLOO_RENDEZVOUS_PORT", str(rdv.port)),
                        ("HOROVOD_HOSTNAME", "localhost"),
                        ("HOROVOD_LOCAL_RANK", "0"),
                        ("HOROVOD_TPU_PLATFORM", "cpu"),
                        ("HOROVOD_TPU_COORDINATOR", "@rendezvous"),
                        ("HOROVOD_TPU_WORLD_VERSION", "0"),
                        ("HOROVOD_TPU_NUM_PROCESSES", "1"),
                        ("HOROVOD_TPU_PROCESS_ID", "0"),
                        ("HOROVOD_RANK", "0")):
        monkeypatch.setenv(knob, value)
    try:
        hvd.init()
        st = hvd.global_state()
        assert hvd.is_initialized() and st.backend.removed
        assert st.engine is None and hvd.rank() == 0 and hvd.size() == 1
        ran = []
        assert hvd.elastic.run(lambda s: ran.append(s))(
            ObjectState(batch=0)) is None
        assert ran == []
        hvd.shutdown()
        Rendezvous.slot = SlotInfo("localhost", 0, 0, 0, 1, 1, 1)
        hvd.init()
        assert not st.backend.removed and st.engine is not None
        assert hvd.size() == 1 and hvd.device() == torch.device("cpu")
        assert os.environ["HOROVOD_TPU_WORLD_VERSION"] == "1"
    finally:
        hvd.shutdown()
        rdv.stop()
        monkeypatch.undo()
        hvd.init(device="cpu")

class TestDurableTier:
    @pytest.fixture()
    def ckpt_world(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HOROVOD_TPU_CHECKPOINT_DIR", str(tmp_path))
        hvd.shutdown()
        hvd.init(device="cpu")
        yield hvd.global_state().checkpoint_manager
        monkeypatch.delenv("HOROVOD_TPU_CHECKPOINT_DIR")
        hvd.shutdown()
        hvd.init(device="cpu")

    def test_fresh_process_restores_the_newest_generation(self, ckpt_world):
        mgr = ckpt_world
        assert mgr is not None
        model = _model(6)
        opt = _adamw(model)
        _steps(model, opt, 2)
        state = TPUState(params=model, opt_state=opt, step=2)
        state.commit()
        assert mgr.wait_idle(30)
        want = _snapshot(model, opt)
        # a fresh process: new model and optimizer, no in-memory commit
        fresh = _model(7)
        fresh_opt = _adamw(fresh)
        params = list(fresh.parameters())
        restored = TPUState(params=fresh, opt_state=fresh_opt, step=0)
        ran, got = [], []

        @hvd.elastic.run
        def train(s):
            ran.append(s.step)
            got.append(_snapshot(fresh, fresh_opt))

        train(restored)
        assert ran == [2] and restored._durable_step == 1
        _assert_bitwise(got[0], want)
        assert all(a is b for a, b in
                   zip(params, fresh_opt.param_groups[0]["params"]))
        # the next step from the restored state is the committed run's
        assert _steps(fresh, fresh_opt, 1) == _steps(model, opt, 1)

    def test_no_generation_leaves_a_fresh_optimizer_alone(self, ckpt_world):
        model = _model(8)
        opt = _adamw(model)
        state = TPUState(params=model, opt_state=opt, step=0)
        assert not state._restore_durable(ckpt_world)
        assert not opt.state

    def test_zero1_state_is_excluded_with_a_warning(self, ckpt_world,
                                                    caplog):
        model = _model(9)
        opt = hvd.DistributedOptimizer(_adamw(model), sharded=True)
        _steps(model, opt, 1)
        state = TPUState(params=model, opt_state=opt, step=1)
        with caplog.at_level(logging.WARNING,
                             logger="horovod_tpu_torch.elastic"):
            state.commit()
            state.commit()
        assert ckpt_world.wait_idle(30)
        warned = [r for r in caplog.records
                  if "excludes the ZeRO-1" in r.getMessage()]
        assert len(warned) == 1
        res = ckpt_world.restore_latest()
        n_model = len(model.state_dict())
        assert len(res.tree) == n_model   # the model's leaves only


def test_zero1_layout_refuses_a_new_world_size(tmp_path):
    """A ZeRO-1 optimizer whose layout froze in a world of 2 raises in the
    world of 1 that follows it (the reference's semantics: build a new
    optimizer over the broadcast parameters)."""
    res = run_world("elastic_zero1", 2, tmp_path, timeout=60)
    assert res[0]["raised"] and "layout mismatch" in res[0]["message"]
    assert res[0]["fresh_ok"]



def test_every_process_group_has_the_worlds_timeout(tmp_path):
    """A dead peer must surface within the world's bound on every group:
    torch gives ``new_group`` its own 30-minute default, so the engine's
    tree pairs and island groups and a training mesh's groups are made
    with the world's timeout (``HOROVOD_TPU_SHUTDOWN_TIMEOUT``, 60 s in
    these worlds). A survivor of a dead peer once waited out the default
    inside a tree round on 4 ranks."""
    res = run_world("group_timeouts", 4, tmp_path, local_size=2, timeout=60)
    for r in res:
        assert r["world"] == 60.0
        assert len(r["groups"]) >= 5
        assert r["groups"] == [60.0] * len(r["groups"]), r

class TestNotificationRoundtrip:
    def test_driver_push_reaches_listener(self):
        from horovod_tpu_torch.elastic.worker import (
            WorkerNotificationClient, WorkerNotificationManager)
        from horovod_tpu_torch.runner.http_server import KVStoreServer

        rdv = KVStoreServer()
        rdv.start()
        try:
            mgr = WorkerNotificationManager()
            mgr.init(rendezvous_addr="127.0.0.1", rendezvous_port=rdv.port,
                     rank=0, hostname="127.0.0.1")
            events = []

            class Listener:
                def on_hosts_updated(self, ts, res):
                    events.append((ts, res))

            mgr.register_listener(Listener())
            # the driver reads the advertised address from the KV store
            addr = rdv.snapshot()["worker_addresses"]["0"].decode()
            WorkerNotificationClient(addr).notify_hosts_updated(
                42, HostUpdateResult.REMOVED)
            deadline = time.monotonic() + 5
            while not events and time.monotonic() < deadline:
                time.sleep(0.05)
            assert events == [(42, HostUpdateResult.REMOVED)]
            mgr.shutdown()
        finally:
            rdv.stop()
