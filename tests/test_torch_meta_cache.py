"""horovod_tpu_torch's steady-state size cache (``Engine.
_exchange_sizes_cached`` and ``_verify_deferred``), against the JAX
package's (the size-cache cases of ``tests/test_multiprocess.py``).

At np=2 on gloo (``torch_worker.py``'s ``meta_cache`` scenario) the
reference's four cases, with its markers: after the warm-up, ten rounds of
an uneven allgather and an uneven alltoall (and a broadcast) make no
blocking host fetch and twenty deferred checks, with the reference's row
counts; with ``HOROVOD_TPU_META_CACHE=0`` twenty fetches and no check
(``slow``, as in the reference); a rank whose rows change after the entry
went hot makes every rank raise (never hang), and the next call
negotiates 1 + 2 rows; a joined rank's zero substitute replays a hot
uneven allgather with the size it advertised before (2 live + 3 zero
rows).

In this process, both packages' caches are driven through the same
sequence of world observations over a stubbed two-rank exchange: each
call must go hot (posted) or stay blocking alike, and a rank's own change
after the entry went hot must raise the reference's error. At size 1
neither package exchanges anything.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import horovod_tpu as ref_hvd
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.core.state import engine as port_engine
from torch_worker import META_ROUNDS, run_world


@pytest.fixture
def engines(monkeypatch):
    """Both packages' size-1 engines."""
    for var in ("HOROVOD_TPU_COORDINATOR", "HOROVOD_TPU_NUM_PROCESSES",
                "HOROVOD_TPU_META_CACHE", "HOROVOD_TPU_META_CACHE_WARMUP"):
        monkeypatch.delenv(var, raising=False)
    ref_hvd.init()
    hvd.init(device="cpu")
    ref = ref_hvd._engine()
    saved = (ref.config.meta_cache, ref.config.meta_cache_warmup)
    try:
        yield ref, port_engine()
    finally:
        ref.config.meta_cache, ref.config.meta_cache_warmup = saved
        hvd.shutdown()


class _Work:
    def wait(self):
        pass

    def is_completed(self):
        return True


def _stub_port(monkeypatch, port, peer, calls):
    """The port's engine as rank 0 of two whose peer's row is ``peer``:
    blocking exchanges counted in ``calls["port"]``."""
    def rows(vec):
        calls["port"] += 1
        return np.stack([np.asarray(vec, dtype=np.int64), peer])

    monkeypatch.setattr(port.backend, "size", lambda: 2)
    monkeypatch.setattr(port, "_exchange_rows", rows)
    monkeypatch.setattr(
        port, "_dispatch_exchange",
        lambda vec: (_Work(), torch.zeros(2 * len(vec), dtype=torch.int64)))


def _stub_ref(monkeypatch, ref, peer, calls):
    """The reference's engine likewise (``_exchange_sizes`` blocks)."""
    def exchange(vec):
        calls["ref"] += 1
        return np.stack([np.asarray(vec), peer])

    monkeypatch.setattr(ref.backend, "size", lambda: 2)
    monkeypatch.setattr(ref, "_exchange_sizes", exchange)
    monkeypatch.setattr(ref, "_dispatch_exchange", lambda vec: None)


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("warmup", [1, 2, 3])
def test_cache_decisions_match_the_reference(engines, monkeypatch, warmup,
                                             enabled):
    """The same observations drive both caches hot or blocking alike; a
    change of this rank's own row once hot stands on the cached world and
    is marked stale; after that entry's error the next call negotiates
    again and the streak restarts."""
    ref, port = engines
    calls = {"ref": 0, "port": 0}
    _stub_ref(monkeypatch, ref, np.array([5]), calls)
    _stub_port(monkeypatch, port, np.array([5]), calls)
    for eng in (ref, port):
        eng.config.meta_cache = enabled
        eng.config.meta_cache_warmup = warmup
        eng._meta_cache.clear()
    trail = {"ref": [], "port": []}
    locals_ = [3] * (warmup + 3) + [4] + [4] * (warmup + 2)
    for i, d0 in enumerate(locals_):
        for tag, eng in (("ref", ref), ("port", port)):
            world, deferred = eng._exchange_sizes_cached(
                "allgather", 77, np.array([d0], dtype=np.int32))
            stale = None if deferred is None else deferred["stale_local"]
            trail[tag].append((deferred is not None, stale,
                               [int(v) for v in np.asarray(world)[:, 0]]))
            if stale:
                with pytest.raises(Exception, match="size cache mismatch"):
                    eng._verify_deferred(f"n{i}", deferred)
    assert trail["ref"] == trail["port"]
    assert calls["ref"] == calls["port"]
    hot = [t[0] for t in trail["port"]]
    if not enabled:
        assert not any(hot)
    else:
        assert hot[:warmup] == [False] * warmup
        assert hot[warmup] is True
        # the change: stale, raised; then a fresh negotiation
        assert trail["port"][warmup + 3][1] is True
        assert hot[warmup + 4] is False


def test_mismatch_is_remembered(engines, monkeypatch):
    """Every later extract of a mismatched handle raises the same error
    (the outcome is kept), and the entry is gone."""
    _, port = engines
    _stub_port(monkeypatch, port, np.array([1, 1]), {"port": 0})
    port.config.meta_cache_warmup = 1
    port._exchange_sizes_cached("alltoall", 9, np.array([1, 1]))
    _, deferred = port._exchange_sizes_cached("alltoall", 9,
                                              np.array([2, 0]))
    assert deferred["stale_local"]
    with pytest.raises(HorovodInternalError) as first:
        port._verify_deferred("x", deferred)
    assert ("alltoall", 9) not in port._meta_cache
    with pytest.raises(HorovodInternalError) as again:
        port._verify_deferred("x", deferred)
    assert again.value is first.value
    assert port.deferred_meta_checks == 0


def test_size_one_exchanges_nothing(engines):
    """At size 1 neither package exchanges or caches sizes, and the
    results are the inputs."""
    ref, port = engines
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    f_ref, f_port = ref.host_fetches, port.host_fetches
    for i in range(4):
        want = np.asarray(ref.allgather(jnp.asarray(x), name="s1.ag")
                          .synchronize())
        got = port.allgather(torch.from_numpy(x), name="s1.ag").synchronize()
        assert np.array_equal(got.numpy(), want)
        out, recv = port.alltoall(torch.from_numpy(x), splits=[3],
                                  name="s1.a2a").synchronize()
        assert np.array_equal(out.numpy(), x) and recv.tolist() == [3]
    assert ref.host_fetches == f_ref and port.host_fetches == f_port
    assert port.deferred_meta_checks == 0
    assert not port._meta_cache


# ---------------------------------------------------------------------------
# np=2 (torch_worker's meta_cache scenario)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("meta_cache", 2, tmp_path_factory.mktemp("meta"))


@pytest.mark.integration
def test_steady_state_sized_ops_no_host_roundtrips(world):
    for rank, r in enumerate(world):
        assert r["fetches"] == 0, r["fetches"]
        assert r["checks"] == 2 * META_ROUNDS, r["checks"]
        assert r["g"].shape == (3, 2)                # 1 + 2 uneven rows
        assert r["g"][:1].tolist() == [[0.0, 0.0]]
        assert r["g"][1:].tolist() == [[1.0, 1.0]] * 2
        assert r["counts"] == [1, 2]                 # rank 0: 1, rank 1: 2
        assert r["recv"].shape == (3, 1)
        assert r["recv"][:, 0].tolist() == [0.0, 1.0, 1.0]
        assert r["b"] == 7.0


@pytest.mark.slow          # the knob-off variant, as the reference marks it
@pytest.mark.integration
def test_sized_ops_with_meta_cache_disabled(tmp_path):
    res = run_world("meta_cache", 2, tmp_path,
                    env={"HOROVOD_TPU_META_CACHE": "0"})
    for r in res:
        assert r["fetches"] == 2 * META_ROUNDS, r["fetches"]
        assert r["checks"] == 0
        assert r["g"].shape == (3, 2) and r["recv"].shape == (3, 1)
        assert r["b"] == 7.0


@pytest.mark.integration
def test_meta_cache_mismatch_raises_everywhere(world):
    """Both ranks raise the reference's error at every extract, then the
    renegotiated gather holds 1 + 2 rows."""
    for r in world:
        errors = r["mismatch"]["errors"]
        assert len(errors) == 2, errors
        assert all(e.startswith("steady-state size cache mismatch for "
                                "'mm.ag'") for e in errors)
        assert r["mismatch"]["after"].tolist() == \
            [[1.0, 1.0], [2.0, 2.0], [2.0, 2.0]]


@pytest.mark.integration
def test_join_substitute_respects_hot_size_cache(world):
    r0, r1 = world
    g = r0["join_gather"]
    assert g.shape == (5, 2)            # 2 live + 3 zero-substitute rows
    assert (g[:2] == 7.0).all() and (g[2:] == 0.0).all()
    assert r0["last_joined"] == r1["last_joined"] == 0
