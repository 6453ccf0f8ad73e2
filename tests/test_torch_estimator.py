"""horovod_tpu_torch's estimator layer (``estimator.py``, ``data.py``,
``store.py``) against the JAX package's.

The ten tests of ``tests/test_estimator.py`` run here on the port with the
same assertions (``memory://`` for ``RemoteStore``; the np=2 uneven-shards
``join`` on gloo through the port's runner, replicas bitwise equal). Across
packages, from the same numpy inputs and the same initial weights (carried
by ``models/convert.py``'s ``mlp_from_jax`` and ``transformer_from_jax``):

- ``fit`` of the MLP (8, 16, 3), 2 shuffled epochs with a ``val_acc``
  metric: under SGD 0.05 against ``optax.sgd(0.05)`` the train losses
  within 1e-5 relative, ``val_acc`` equal and the final parameters within
  1e-5; under Adam 1e-2 against ``optax.adam(1e-2)`` within 1e-4 (torch's
  Adam is 1.3e-6 off optax a step, ROADMAP C0), the parameters after the
  first epoch (``test_mlp_fit_matches_reference`` says why); a resume
  gives the reference's epochs and checkpoint steps;
- ``fit`` of a 2-layer LM (d 64, 4 x 16 heads, T 32, vocab 256, batch 2,
  fp32) with ``lean_lm_loss``: epoch losses within 1e-5 relative (the
  port's attention takes its kernels' plain versions on the CPU);
- ``data.py``: shards written by either package read equal through the
  other, and ``iter_batches`` gives the reference's exact batches for seeds
  0 and 1 at ranks (0, 2) and (1, 2); an abandoned epoch leaves no live
  loader thread;
- ``store.py``: a run directory the reference wrote gives the same steps,
  and loading one of its steps raises the format error.
"""

import os
import threading

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from horovod_tpu import data as ref_data
from horovod_tpu.estimator import Estimator as RefEstimator
from horovod_tpu.models import transformer as JT
from horovod_tpu.models.mlp import (init_mlp, mlp_forward,
                                    softmax_cross_entropy as ref_xent)
from horovod_tpu.store import LocalStore as RefLocalStore

import horovod_tpu_torch as hvd
from horovod_tpu_torch import data as data_mod
from horovod_tpu_torch.data import ShardedNpzDataset
from horovod_tpu_torch.estimator import Estimator, TrainedModel
from horovod_tpu_torch.models.convert import mlp_from_jax, transformer_from_jax
from horovod_tpu_torch.models.mlp import MLP, softmax_cross_entropy
from horovod_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  lean_lm_loss)
from horovod_tpu_torch.store import LocalStore, RemoteStore, Store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_DIMS = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
               max_seq=32)


@pytest.fixture(autouse=True)
def world(monkeypatch):
    """A size-1 gloo world for each test (the estimator's ``hvd.init()``
    would ask for a card)."""
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


def _acc(m, x, y):
    return (m(x).argmax(1) == y).float().mean()


def _make_estimator(store, epochs=2, run_id="run1", init_fn=None,
                     optimizer=None):
    return Estimator(
        init_fn=init_fn or (lambda g: MLP((8, 16, 3), generator=g)),
        forward_fn=lambda m, x: m(x),
        loss_fn=lambda m, x, y: softmax_cross_entropy(m(x), y.long()),
        optimizer=optimizer or (lambda ps: torch.optim.Adam(ps, lr=1e-2)),
        store=store, run_id=run_id, epochs=epochs, batch_size=16,
        metric_fns={"acc": _acc})


def _data(n=256, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 8).astype(np.float32)
    y = (x.sum(axis=1) > 4).astype(np.int32) + (x[:, 0] > 0.5)
    return x, y.astype(np.int32)


# ---------------------------------------------------------------------------
# the reference's tests/test_estimator.py, on the port
# ---------------------------------------------------------------------------

def test_store_checkpoint_roundtrip(tmp_path):
    store = Store.create(str(tmp_path / "store"))
    assert isinstance(store, LocalStore)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [np.float64(3.5), np.int32(7)]}
    store.save_checkpoint("r", 0, tree)
    store.save_checkpoint("r", 3, tree)
    assert store.latest_checkpoint_step("r") == 3
    assert store.checkpoint_steps("r") == [0, 3]
    out = store.load_checkpoint("r")
    assert torch.equal(out["a"], tree["a"]) and out["a"].device.type == "cpu"
    assert float(out["b"][0]) == 3.5 and int(out["b"][1]) == 7


def test_store_scheme_routing(tmp_path):
    assert isinstance(Store.create(f"file://{tmp_path}/s"), LocalStore)
    assert isinstance(Store.create("memory://route-test"), RemoteStore)


def test_estimator_fit_and_predict(tmp_path):
    store = Store.create(str(tmp_path / "store"))
    est = _make_estimator(store, epochs=2)
    x, y = _data()
    model = est.fit((x, y), val_data=(x, y))
    assert isinstance(model, TrainedModel)
    assert len(model.history) == 2
    assert model.history[0]["train_loss"] > 0
    assert "val_acc" in model.history[0]
    # training reduced the loss
    assert model.history[-1]["train_loss"] <= model.history[0]["train_loss"]
    preds = model.predict(x[:10])
    assert isinstance(preds, np.ndarray) and preds.shape == (10, 3)
    # checkpoints were written per epoch
    assert store.checkpoint_steps("run1") == [0, 1]


def test_estimator_resume(tmp_path):
    store = Store.create(str(tmp_path / "store"))
    x, y = _data()
    _make_estimator(store, epochs=1, run_id="r2").fit((x, y))
    assert store.latest_checkpoint_step("r2") == 0
    # second fit with more epochs resumes from epoch 1 (not from scratch)
    model = _make_estimator(store, epochs=3, run_id="r2").fit((x, y))
    assert [h["epoch"] for h in model.history] == [1, 2]
    assert store.checkpoint_steps("r2") == [0, 1, 2]


def test_remote_store_roundtrip():
    """Store.create routes scheme:// prefixes to the fsspec RemoteStore
    (reference HDFSStore role, spark/common/store.py:256); memory:// gives a
    hermetic fake remote filesystem."""
    st = Store.create("memory://torch-ckpt-roundtrip")
    assert isinstance(st, RemoteStore)
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "opt": [torch.tensor(2.5), torch.zeros(4)]}
    st.save_checkpoint("runA", 1, tree)
    st.save_checkpoint("runA", 5, tree)
    assert st.latest_checkpoint_step("runA") == 5
    assert st.checkpoint_steps("runA") == [1, 5]
    back = st.load_checkpoint("runA", step=1)
    assert torch.equal(back["w"], tree["w"])
    assert float(back["opt"][0]) == 2.5
    assert st.load_checkpoint("missing-run") is None


def test_estimator_with_remote_store():
    """The estimator trains, checkpoints, and resumes against a
    RemoteStore — the preemptible-VM elastic checkpointing path."""
    st = Store.create("memory://torch-est-remote")
    x, y = _data()
    model = _make_estimator(st, epochs=2, run_id="rr").fit((x, y))
    assert len(model.history) == 2
    assert st.checkpoint_steps("rr") == [0, 1]
    # resume picks up from the stored checkpoint
    model2 = _make_estimator(st, epochs=3, run_id="rr").fit((x, y))
    assert [h["epoch"] for h in model2.history] == [2]


@pytest.mark.integration
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_estimator_uneven_shards_join(tmp_path, opt):
    """An on-disk sharded dataset with UNEVEN per-rank sample counts
    trains to completion at np=2 on gloo, through the port's runner: the
    ragged tail flows through join() instead of deadlocking or dropping
    data, and the replicas (and Adam's state) are bitwise equal after the
    re-broadcast from the last joiner. ``sgd`` is the reference's case;
    ``adam`` adds optimizer state to re-broadcast."""
    from horovod_tpu_torch.runner import run
    from torch_worker import estimator_join_fn

    rng = np.random.RandomState(0)
    x = rng.rand(150, 8).astype(np.float32)
    y = rng.randint(0, 3, size=(150,)).astype(np.int32)
    # 3 shards -> rank 0 gets shards {0, 2} (100 samples = 7 batches of 16),
    # rank 1 gets shard {1} (50 samples = 4 batches): genuinely ragged
    ShardedNpzDataset.write_shards(str(tmp_path / "shards"), x, y, 3)
    results = run(estimator_join_fn, np=2, env={
        "HOROVOD_TPU_PLATFORM": "cpu",
        "HOROVOD_STALL_CHECK_DISABLE": "1",
        "TEST_SHARD_DIR": str(tmp_path / "shards"),
        "TEST_OPTIMIZER": opt,
        "PYTHONPATH": os.pathsep.join(
            [REPO, os.path.join(REPO, "tests"),
             os.environ.get("PYTHONPATH", "")])})
    for r in results:
        assert r["epochs"] == 2, r
        assert r["losses_finite"], r
        assert r["batches"] == [7, 4][r["rank"]]
    # replicas must NOT diverge after uneven epochs: the estimator
    # re-broadcasts the model and the optimizer state from the last joiner
    a, b = results
    assert len(a["params"]) == len(b["params"]) == 4
    for u, v in zip(a["params"] + a["state"], b["params"] + b["state"]):
        np.testing.assert_array_equal(u, v)
    assert len(a["state"]) == {"sgd": 0, "adam": 12}[opt]


def test_sharded_npz_dataset_roundtrip(tmp_path):
    x = np.arange(20.0).reshape(10, 2)
    y = np.arange(10)
    ds = ShardedNpzDataset.write_shards(str(tmp_path / "s"), x, y, 4)
    assert len(ds) == 4
    x0, y0 = ds.shard_arrays(0, 2)   # shards 0, 2
    x1, y1 = ds.shard_arrays(1, 2)   # shards 1, 3
    got = np.sort(np.concatenate([y0, y1]))
    np.testing.assert_array_equal(got, y)
    # more ranks than shards: empty shard with right dtype/shape
    xe, ye = ds.shard_arrays(5, 6)
    assert xe.shape == (0, 2) and len(ye) == 0


def test_shard_batch_iterator_streams_bounded(tmp_path):
    """The streaming reader covers every sample exactly once per epoch
    with batches crossing shard boundaries, reshuffles per epoch, and never
    holds more than prefetch + 2 shards in RAM — the dataset (12 shards) is
    far larger than the buffer (prefetch=1 -> <= 3 resident)."""
    x = np.arange(120.0).reshape(60, 2)
    y = np.arange(60)
    ds = ShardedNpzDataset.write_shards(str(tmp_path / "s"), x, y, 12)

    it = ds.iter_batches(0, 1, batch_size=8, shuffle=True, seed=0, prefetch=1)
    batches = list(it)
    got = np.sort(np.concatenate([b[1] for b in batches]))
    np.testing.assert_array_equal(got, y)            # exact coverage
    assert [len(b[1]) for b in batches] == [8] * 7 + [4]  # cross-shard + tail
    # queue(1) + loader in-hand(1) + consumer current(1), regardless of
    # loader/consumer race timing
    assert it.max_resident_shards <= 3, it.max_resident_shards

    # per-epoch reshuffle: different seed -> different order, same coverage
    e2 = [b[1] for b in ds.iter_batches(0, 1, 8, shuffle=True, seed=1)]
    assert not all(np.array_equal(a[1], b)
                   for a, b in zip(batches, e2))
    np.testing.assert_array_equal(np.sort(np.concatenate(e2)), y)

    # two ranks: disjoint, complete
    r0 = np.concatenate([b[1] for b in ds.iter_batches(0, 2, 8, seed=0)])
    r1 = np.concatenate([b[1] for b in ds.iter_batches(1, 2, 8, seed=0)])
    np.testing.assert_array_equal(np.sort(np.concatenate([r0, r1])), y)

    # more ranks than shards: empty iterator
    assert list(ds.iter_batches(15, 16, 8)) == []


def test_estimator_streams_dataset_larger_than_buffer(tmp_path,
                                                      monkeypatch):
    """The estimator trains from a sharded dataset without ever loading a
    rank's whole partition (shard_arrays is NOT called; residency stays at
    the prefetch bound)."""
    x, y = _data(n=240)
    ds = data_mod.ShardedNpzDataset.write_shards(str(tmp_path / "s"), x, y,
                                                 16)
    seen = {}
    orig = data_mod.ShardedNpzDataset.iter_batches

    def spy(self, *a, **kw):
        it = orig(self, *a, **kw)
        seen["it"] = it
        return it

    def refuse(self, *a, **kw):
        raise AssertionError("shard_arrays loads a whole partition")

    monkeypatch.setattr(data_mod.ShardedNpzDataset, "iter_batches", spy)
    monkeypatch.setattr(data_mod.ShardedNpzDataset, "shard_arrays", refuse)
    model = _make_estimator(None, epochs=2).fit(ds)
    assert len(model.history) == 2
    assert all(np.isfinite(h["train_loss"]) for h in model.history)
    assert seen["it"].max_resident_shards <= 4   # prefetch(2) + 2


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

def _ref_mlp(seed=0):
    return init_mlp(jax.random.PRNGKey(seed), sizes=(8, 16, 3))


def _port_mlp(ref_params):
    def init(generator):
        m = MLP((8, 16, 3))
        m.load_state_dict(mlp_from_jax(ref_params))
        return m
    return init


def _ref_acc(p, x, y):
    return jnp.mean((jnp.argmax(mlp_forward(p, x), axis=1) == y)
                    .astype(jnp.float32))


def _ref_estimator(params, optimizer, store=None, epochs=2, run_id="run1"):
    return RefEstimator(
        init_fn=lambda rng: params, forward_fn=mlp_forward,
        loss_fn=lambda p, x, y: ref_xent(mlp_forward(p, x), y),
        optimizer=optimizer, store=store, run_id=run_id, epochs=epochs,
        batch_size=16, metric_fns={"acc": _ref_acc})


# kind -> (the reference's optimizer, the port's, the tolerance, the epochs
# after which the parameters are compared)
OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.05),
            lambda ps: torch.optim.SGD(ps, lr=0.05), 1e-5, 2),
    "adam": (lambda: optax.adam(1e-2),
             lambda ps: torch.optim.Adam(ps, lr=1e-2), 1e-4, 1),
}


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_mlp_fit_matches_reference(kind):
    """Two shuffled epochs: train losses within the tolerance, val_acc
    equal; the parameters and predictions within it after the epochs the
    table names. Under Adam they are compared after the first epoch: at
    step 31, in the second, a ReLU pre-activation of hidden unit 5 lies
    within the packages' rounding (1e-6) of zero on one sample, so each
    package puts it on another side, and Adam moves that unit's 8 weights
    and bias up to 6e-4 apart; the losses stay within 3e-7."""
    ref_opt, port_opt, tol, param_epochs = OPTIMIZERS[kind]
    x, y = _data()
    params = _ref_mlp()
    for epochs in sorted({param_epochs, 2}):
        want = _ref_estimator(params, ref_opt(), epochs=epochs).fit(
            (x, y), val_data=(x, y))
        got = _make_estimator(None, epochs, init_fn=_port_mlp(params),
                              optimizer=port_opt).fit((x, y),
                                                      val_data=(x, y))
        assert [h["epoch"] for h in got.history] == list(range(epochs))
        for g, w in zip(got.history, want.history):
            np.testing.assert_allclose(g["train_loss"], w["train_loss"],
                                       rtol=tol)
            assert g["val_acc"] == w["val_acc"]
        if epochs != param_epochs:
            continue
        final = mlp_from_jax(jax.device_get(want.params))
        state = got.params.state_dict()
        for name, w in final.items():
            np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                       rtol=tol, atol=tol)
        np.testing.assert_allclose(
            got.predict(x[:10]),
            np.asarray(mlp_forward(want.params, jnp.asarray(x[:10]))),
            rtol=tol, atol=tol)


def test_resume_matches_reference(tmp_path):
    ref_opt, port_opt, tol, _ = OPTIMIZERS["adam"]
    x, y = _data()
    params = _ref_mlp()
    ref_store = RefLocalStore(str(tmp_path / "ref"))
    store = LocalStore(str(tmp_path / "port"))
    histories = []
    for epochs in (1, 3):
        _ref = _ref_estimator(params, ref_opt(), ref_store, epochs, "r2")
        port = _make_estimator(store, epochs, "r2", _port_mlp(params),
                               port_opt)
        histories.append((_ref.fit((x, y)).history, port.fit((x, y)).history))
    want, got = histories[1]
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == [1, 2]
    assert store.checkpoint_steps("r2") == \
        ref_store.checkpoint_steps("r2") == [0, 1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"],
                                   rtol=tol)


def test_lm_fit_matches_reference():
    """The slice as a whole on the CPU: a 2-layer LM through both
    packages' estimators, SGD 0.5, 2 shuffled epochs of 4 batches of 2."""
    jcfg = JT.TransformerConfig(dtype=jnp.float32, attention="flash",
                                **LM_DIMS)
    cfg = TransformerConfig(dtype=torch.float32, attention="flash",
                            **LM_DIMS)
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.RandomState(5).randint(
        0, LM_DIMS["vocab_size"], (8, LM_DIMS["max_seq"] + 1))
    x, y = tokens[:, :-1], tokens[:, 1:]

    def init(generator):
        m = Transformer(cfg)
        m.load_state_dict(transformer_from_jax(params, cfg))
        return m

    want = RefEstimator(
        init_fn=lambda rng: params,
        forward_fn=lambda p, t: JT.forward_block(p, t, jcfg),
        loss_fn=lambda p, a, b: JT.lean_lm_loss(p, a, b, jcfg),
        optimizer=optax.sgd(0.5), epochs=2, batch_size=2).fit((x, y))
    got = Estimator(
        init_fn=init, forward_fn=lambda m, t: m(t),
        loss_fn=lambda m, a, b: lean_lm_loss(m, a, b),
        optimizer=lambda ps: torch.optim.SGD(ps, lr=0.5), epochs=2,
        batch_size=2).fit((x, y))
    losses = [h["train_loss"] for h in got.history]
    assert losses[1] < losses[0]
    np.testing.assert_allclose(losses,
                               [h["train_loss"] for h in want.history],
                               rtol=1e-5)
    np.testing.assert_allclose(
        got.predict(x[:1]),
        np.asarray(JT.forward_block(want.params, jnp.asarray(x[:1]), jcfg)),
        rtol=1e-4, atol=1e-4)


def test_device_defaults_to_the_world_and_never_falls_back(monkeypatch):
    """``device=None`` trains on ``hvd.device()``; with no world and no
    card, ``fit``'s ``hvd.init()`` asks for the card and raises."""
    x, y = _data(n=32)
    model = _make_estimator(None, epochs=1).fit((x, y))
    assert next(model.params.parameters()).device == hvd.device()
    if torch.cuda.is_available():
        return
    hvd.shutdown()
    monkeypatch.delenv("HOROVOD_TPU_PLATFORM", raising=False)
    with pytest.raises(hvd.HorovodInternalError, match="no CUDA device"):
        _make_estimator(None, epochs=1).fit((x, y))
    hvd.init(device="cpu")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_shards_read_equal_across_packages(tmp_path, writer):
    rng = np.random.RandomState(2)
    x = rng.rand(37, 3).astype(np.float32)
    y = rng.randint(0, 5, size=(37,)).astype(np.int64)
    d = str(tmp_path / "s")
    (ShardedNpzDataset if writer == "port"
     else ref_data.ShardedNpzDataset).write_shards(d, x, y, 5)
    port, ref = ShardedNpzDataset(d), ref_data.ShardedNpzDataset(d)
    assert port.paths == ref.paths
    for rank in range(2):
        for a, b in zip(port.shard_arrays(rank, 2), ref.shard_arrays(rank, 2)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rank", [0, 1])
def test_iter_batches_is_the_references_sequence(tmp_path, seed, rank):
    rng = np.random.RandomState(4)
    x = rng.rand(53, 2).astype(np.float32)
    y = np.arange(53)
    ds = ShardedNpzDataset.write_shards(str(tmp_path / "s"), x, y, 7)
    ref = ref_data.ShardedNpzDataset(str(tmp_path / "s"))
    got = list(ds.iter_batches(rank, 2, 5, shuffle=True, seed=seed))
    want = list(ref.iter_batches(rank, 2, 5, shuffle=True, seed=seed))
    assert len(got) == len(want) > 1
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def _loaders():
    return [t for t in threading.enumerate()
            if t.name == "hvd-data-loader" and t.is_alive()]


def test_abandoned_epoch_leaves_no_loader_thread(tmp_path):
    """A ``break`` mid-epoch, and an exception out of ``fit`` mid-epoch,
    each join the loader thread before control returns."""
    x, y = _data(n=96)
    ds = ShardedNpzDataset.write_shards(str(tmp_path / "s"), x, y, 12)
    for i, _ in enumerate(ds.iter_batches(0, 1, 4, prefetch=1)):
        if i == 1:
            break
    assert not _loaders()

    def failing(m, xb, yb, calls=[]):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("reset")
        return softmax_cross_entropy(m(xb), yb.long())

    est = _make_estimator(None, epochs=1)
    est.loss_fn = failing
    with pytest.raises(RuntimeError, match="reset"):
        est.fit(ds)
    assert not _loaders()


def test_reference_run_directory(tmp_path):
    """A run directory the JAX package wrote: the same latest step and
    steps here, and loading one of them raises the format error."""
    ref = RefLocalStore(str(tmp_path / "s"))
    tree = {"w": np.arange(4.0), "n": np.int64(2)}
    ref.save_checkpoint("r", 2, tree)
    ref.save_checkpoint("r", 7, tree)
    port = LocalStore(str(tmp_path / "s"))
    assert port.latest_checkpoint_step("r") == \
        ref.latest_checkpoint_step("r") == 7
    assert port.checkpoint_steps("r") == ref.checkpoint_steps("r") == [2, 7]
    with pytest.raises(RuntimeError, match="needs horovod_tpu"):
        port.load_checkpoint("r")
    with pytest.raises(RuntimeError, match="needs horovod_tpu"):
        port.load_checkpoint("r", step=2)
    # and the port's own steps read back beside them
    port.save_checkpoint("r", 9, {"w": torch.arange(4.0)})
    assert ref.latest_checkpoint_step("r") == 9
    assert torch.equal(port.load_checkpoint("r")["w"], torch.arange(4.0))


@pytest.mark.integration
def test_np2_estimator_world_joins_and_resumes_bitwise(tmp_path):
    """torch_worker's ``estimator`` scenario on gloo (the card's ``-k
    "cards and estimator"`` at the tiny LM's widths): 3 uneven shards, rank
    1 joins halfway each epoch, the replicas and AdamW's state bitwise
    equal after each epoch, rank 0's checkpoints resumed by both ranks."""
    from torch_worker import (check_estimator_world, run_world,
                              write_estimator_data)
    write_estimator_data(str(tmp_path), "cpu")
    res = run_world("estimator", 2, tmp_path,
                    env={"ESTIMATOR_DIR": str(tmp_path)})
    check_estimator_world(res, "cpu")
