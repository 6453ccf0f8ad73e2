"""horovod_tpu_torch's elastic driver, host manager, rendezvous and launcher
against the JAX package's.

The reference's driver cases (``tests/test_elastic_driver.py``: no real
hosts, no subprocesses; ``HostManager``, ``ElasticDriver``,
``ElasticRendezvousServer``) run against the port's copies. One scripted
discovery sequence, with failures, blacklisting, backoff and a timeout
below ``min_np``, goes to both packages' drivers: the slot assignments,
world versions, notifications and blacklists must be equal. The launcher's
``parse_args`` / ``env_from_args`` / ``make_worker_env`` give both packages
the same environment for the same command line.
"""

import threading
import time

import pytest

from horovod_tpu_torch.elastic.discovery import (FixedHosts, HostManager,
                                           HostUpdateResult)
from horovod_tpu_torch.elastic.driver import ElasticDriver
from horovod_tpu_torch.elastic.rendezvous import ElasticRendezvousServer


def wait_until(cond, timeout=10.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


class MockWorkers:
    """Collects create_worker_fn calls; lets tests 'run' workers manually."""

    def __init__(self, driver_ref):
        self.driver_ref = driver_ref
        self.started = []
        self.lock = threading.Lock()

    def create(self, slot):
        with self.lock:
            self.started.append(slot)

    def started_keys(self):
        with self.lock:
            return [(s.hostname, s.local_rank) for s in self.started]


def make_driver(hosts, min_np, max_np=None, reset_limit=None, timeout=5.0):
    discovery = FixedHosts(hosts)
    server = ElasticRendezvousServer()
    server.start()
    driver = ElasticDriver(server, discovery, min_np=min_np, max_np=max_np,
                           timeout=timeout, reset_limit=reset_limit)
    server.set_driver(driver)
    workers = MockWorkers(driver)
    return driver, server, discovery, workers


class TestHostManager:
    def test_update_and_order(self):
        disc = FixedHosts({"a": 2})
        hm = HostManager(disc)
        assert hm.update_available_hosts() == HostUpdateResult.ADDED
        disc.set({"a": 2, "b": 2})
        assert hm.update_available_hosts() == HostUpdateResult.ADDED
        # seniority order preserved
        assert [h.hostname for h in hm.current_hosts()] == ["a", "b"]
        disc.set({"b": 2, "a": 2})
        assert hm.update_available_hosts() == HostUpdateResult.NO_UPDATE
        assert [h.hostname for h in hm.current_hosts()] == ["a", "b"]

    def test_removal_and_slot_change(self):
        disc = FixedHosts({"a": 2, "b": 2})
        hm = HostManager(disc)
        hm.update_available_hosts()
        disc.set({"a": 2})
        assert hm.update_available_hosts() == HostUpdateResult.REMOVED
        disc.set({"a": 4})
        assert hm.update_available_hosts() & HostUpdateResult.MIXED

    def test_blacklist(self):
        disc = FixedHosts({"a": 2, "b": 2})
        hm = HostManager(disc)
        hm.update_available_hosts()
        hm.blacklist("b")
        assert hm.is_blacklisted("b")
        assert hm.available_slots() == 2
        # blacklisted hosts never come back
        hm.update_available_hosts()
        assert [h.hostname for h in hm.current_hosts()] == ["a"]


class TestElasticDriver:
    def test_initial_world(self):
        driver, server, disc, workers = make_driver({"a": 2, "b": 2}, 4)
        try:
            driver.start(4, workers.create)
            assert driver.world_size() == 4
            assert len(workers.started) == 4
            # host-major rank assignment, stable ordering
            s = driver.get_slot_info("a", 0)
            assert s.rank == 0 and s.size == 4
            s = driver.get_slot_info("b", 1)
            assert s.rank == 3 and s.cross_rank == 1
        finally:
            driver.stop()
            server.stop()

    def test_failure_triggers_resume_and_restart(self):
        driver, server, disc, workers = make_driver({"a": 2, "b": 2}, 2,
                                                    max_np=4)
        try:
            driver.start(2, workers.create)
            v1 = driver.world_version
            # b:1 dies
            driver.record_worker_exit("b", 1, exit_code=1)
            assert driver.resume_needed()
            assert driver.get_slot_info("a", 0) is None  # plan is frozen
            # survivors re-rendezvous
            for host, lr in [("a", 0), ("a", 1), ("b", 0)]:
                driver.record_ready(host, lr)
            assert wait_until(lambda: driver.world_version > v1)
            assert wait_until(lambda: not driver.resume_needed())
            # b still discoverable → not blacklisted; failed slot restarted
            assert not driver.host_manager.is_blacklisted("b")
            assert driver.world_size() == 4
            assert wait_until(
                lambda: workers.started_keys().count(("b", 1)) == 2)
        finally:
            driver.stop()
            server.stop()

    def test_dead_host_blacklisted_and_world_shrinks(self):
        driver, server, disc, workers = make_driver({"a": 2, "b": 2}, 2,
                                                    max_np=4)
        try:
            driver.start(4, workers.create)
            v1 = driver.world_version
            disc.set({"a": 2})          # b vanishes from discovery
            driver.record_worker_exit("b", 0, exit_code=1)
            driver.record_worker_exit("b", 1, exit_code=1)
            for host, lr in [("a", 0), ("a", 1)]:
                driver.record_ready(host, lr)
            assert wait_until(lambda: driver.world_version > v1)
            assert driver.host_manager.is_blacklisted("b")
            assert driver.world_size() == 2
            s = driver.get_slot_info("a", 1)
            assert s.rank == 1 and s.size == 2
        finally:
            driver.stop()
            server.stop()

    def test_scale_up_on_new_host(self):
        driver, server, disc, workers = make_driver({"a": 2}, 2, max_np=8)
        try:
            driver.start(2, workers.create)
            v1 = driver.world_version
            disc.set({"a": 2, "c": 2})
            # discovery thread notices (≤ ~1s), marks pending
            assert wait_until(driver.resume_needed, timeout=5)
            driver.record_ready("a", 0)
            driver.record_ready("a", 1)
            assert wait_until(lambda: driver.world_version > v1)
            assert driver.world_size() == 4
            assert wait_until(
                lambda: ("c", 0) in workers.started_keys() and
                        ("c", 1) in workers.started_keys())
        finally:
            driver.stop()
            server.stop()

    def test_no_resume_beyond_max_np(self):
        driver, server, disc, workers = make_driver({"a": 2}, 2, max_np=2)
        try:
            driver.start(2, workers.create)
            disc.set({"a": 2, "c": 2})
            time.sleep(2.5)  # give discovery thread time to (not) react
            assert not driver.resume_needed()
            assert driver.world_size() == 2
        finally:
            driver.stop()
            server.stop()

    def test_reset_limit(self):
        driver, server, disc, workers = make_driver({"a": 2}, 2,
                                                    reset_limit=1)
        try:
            driver.start(2, workers.create)
            v1 = driver.world_version
            # first failure: allowed reset
            driver.record_worker_exit("a", 1, exit_code=1)
            driver.record_ready("a", 0)
            assert wait_until(lambda: driver.world_version > v1)
            # second failure: exceeds limit → job stops with error
            driver.record_worker_exit("a", 1, exit_code=1)
            driver.record_ready("a", 0)
            assert wait_until(driver.finished)
            assert "reset limit" in (driver.error_message or "")
        finally:
            driver.stop()
            server.stop()

    def test_all_success_finishes(self):
        driver, server, disc, workers = make_driver({"a": 2}, 2)
        try:
            driver.start(2, workers.create)
            driver.record_worker_exit("a", 0, exit_code=0)
            driver.record_worker_exit("a", 1, exit_code=0)
            assert wait_until(driver.finished)
            assert driver.error_message is None
        finally:
            driver.stop()
            server.stop()

    def test_wait_for_slots_timeout(self):
        driver, server, disc, workers = make_driver({}, 2, timeout=2.0)
        try:
            with pytest.raises(TimeoutError):
                driver.wait_for_available_slots(2)
        finally:
            driver.stop()
            server.stop()

    def test_degraded_world_on_timeout(self):
        """Requesting np=4 with only 2 slots discoverable times
        out into a DEGRADED world at 2 (>= min_np) instead of aborting."""
        driver, server, disc, workers = make_driver({"a": 2}, 2,
                                                    timeout=1.5)
        try:
            driver.start(4, workers.create)      # must not raise
            assert driver.world_size() == 2
            assert len(workers.started) == 2
        finally:
            driver.stop()
            server.stop()

    def test_timeout_below_min_np_aborts(self):
        """The other timeout arm: fewer usable slots than min_np is a hard
        TimeoutError, degraded continuation is not an option."""
        driver, server, disc, workers = make_driver({"a": 1}, 2,
                                                    timeout=1.5)
        try:
            with pytest.raises(TimeoutError, match="cannot continue"):
                driver.start(2, workers.create)
        finally:
            driver.stop()
            server.stop()

    def test_repeat_failing_slot_suspended_with_backoff(self, monkeypatch):
        """A slot that fails repeatedly is suspended (world rebuilt without
        it) instead of re-admitted into every world; after the backoff
        expires it becomes usable again."""
        monkeypatch.setenv("HOROVOD_ELASTIC_FAILURE_BACKOFF", "1.0")
        driver, server, disc, workers = make_driver({"a": 3}, 1, max_np=3)
        try:
            driver.start(3, workers.create)
            assert driver.world_size() == 3
            v1 = driver.world_version
            # strike 1 (free): slot a:2 dies, world rebuilt at 3
            driver.record_worker_exit("a", 2, exit_code=1)
            for lr in (0, 1):
                driver.record_ready("a", lr)
            assert wait_until(lambda: driver.world_version > v1)
            assert driver.world_size() == 3
            assert driver.slot_strikes("a:2") == 1
            v2 = driver.world_version
            # strike 2: suspension kicks in, the rebuilt world excludes it
            driver.record_worker_exit("a", 2, exit_code=1)
            for lr in (0, 1):
                driver.record_ready("a", lr)
            assert wait_until(lambda: driver.world_version > v2)
            assert driver.slot_strikes("a:2") == 2
            assert driver.world_size() == 2
            # after the ~1s backoff the slot is usable again
            assert wait_until(
                lambda: driver._usable_hosts()[1] == 3, timeout=10)
        finally:
            driver.stop()
            server.stop()

    def test_slot_failure_limit_blacklists_host(self, monkeypatch):
        """Past HOROVOD_ELASTIC_SLOT_FAILURE_LIMIT the failing slot's HOST
        is blacklisted (capacity suspension alone cannot pin a physical
        device, so only the host exclusion converges)."""
        monkeypatch.setenv("HOROVOD_ELASTIC_SLOT_FAILURE_LIMIT", "3")
        driver, server, disc, workers = make_driver({"a": 1, "b": 1}, 1,
                                                    max_np=2)
        try:
            driver.start(2, workers.create)
            for _ in range(3):
                driver.record_worker_exit("b", 0, exit_code=1)
            assert driver.slot_strikes("b:0") == 3
            assert driver.host_manager.is_blacklisted("b")
            assert not driver.host_manager.is_blacklisted("a")
        finally:
            driver.stop()
            server.stop()

    def test_suspension_readmitted_to_preserve_min_np(self, monkeypatch):
        """Quarantine never starves the job: when suspending the striking
        slots would drop the world below min_np, they are re-admitted."""
        monkeypatch.setenv("HOROVOD_ELASTIC_FAILURE_BACKOFF", "30")
        driver, server, disc, workers = make_driver({"a": 2}, 2, max_np=2)
        try:
            driver.start(2, workers.create)
            v1 = driver.world_version
            for _ in range(2):   # two strikes on a:1 → would suspend it
                driver.record_worker_exit("a", 1, exit_code=1)
            driver.record_ready("a", 0)
            driver.record_ready("a", 1)
            assert wait_until(lambda: driver.world_version > v1)
            # min_np=2 forces re-admission despite the strikes
            assert driver.world_size() == 2
            assert driver.slot_strikes("a:1") == 2
        finally:
            driver.stop()
            server.stop()


class TestElasticRendezvous:
    def test_get_records_ready_and_serves_slots(self):
        driver, server, disc, workers = make_driver({"a": 2}, 2)
        try:
            driver.start(2, workers.create)
            from horovod_tpu_torch.runner.http_client import read_data_from_kvstore
            from horovod_tpu_torch.runner.hosts import SlotInfo
            data = read_data_from_kvstore("127.0.0.1", server.port,
                                          "rank_and_size", "a:1", timeout=5)
            slot = SlotInfo.from_response_string(data.decode())
            assert slot.rank == 1 and slot.size == 2
            assert driver.registry.count("READY") >= 1
        finally:
            driver.stop()
            server.stop()

    def test_worker_addresses_roundtrip(self):
        driver, server, disc, workers = make_driver({"a": 2}, 2)
        try:
            driver.start(2, workers.create)
            from horovod_tpu_torch.runner.http_client import put_data_into_kvstore
            put_data_into_kvstore("127.0.0.1", server.port,
                                  "worker_addresses", "0",
                                  b"127.0.0.1:9999")
            assert server.worker_addresses() == {"0": "127.0.0.1:9999"}
        finally:
            driver.stop()
            server.stop()


# -- parity with the JAX package's driver and launcher ----------------------

def _modules(pkg: str):
    import importlib
    root = "horovod_tpu" if pkg == "ref" else "horovod_tpu_torch"
    return [importlib.import_module(f"{root}.{m}") for m in
            ("elastic.discovery", "elastic.driver", "elastic.rendezvous",
             "elastic.worker", "runner.http_client")]


def _script(pkg: str, monkeypatch) -> list:
    """One discovery and failure sequence through one package's driver;
    returns what the driver decided at each point."""
    disc_mod, drv_mod, rdv_mod, worker_mod, client = _modules(pkg)
    notes = []

    class Recorder:
        def __init__(self, addr):
            self.addr = addr

        def notify_hosts_updated(self, timestamp, update_res):
            notes.append((self.addr, update_res))

    monkeypatch.setattr(worker_mod, "WorkerNotificationClient", Recorder)
    monkeypatch.setenv("HOROVOD_ELASTIC_FAILURE_BACKOFF", "30")
    monkeypatch.setenv("HOROVOD_ELASTIC_SLOT_FAILURE_LIMIT", "4")
    disc = disc_mod.FixedHosts({"a": 2, "b": 2})
    server = rdv_mod.ElasticRendezvousServer()
    server.start()
    driver = drv_mod.ElasticDriver(server, disc, min_np=2, max_np=4,
                                   timeout=5.0)
    server.set_driver(driver)
    started = []
    trail = []

    def world():
        with driver._lock:
            slots = [s.to_response_string() for s in driver._assignments]
        return dict(version=driver.world_version, slots=slots,
                    blacklist=[h for h in ("a", "b")
                               if driver.host_manager.is_blacklisted(h)],
                    strikes={k: driver.slot_strikes(k) for k in
                             ("a:0", "a:1", "b:0", "b:1")},
                    started=list(started))

    def advertise():
        # every worker of the world registers its notification address
        for rank in range(driver.world_size()):
            client.put_data_into_kvstore("127.0.0.1", server.port,
                                         "worker_addresses", str(rank),
                                         f"w{rank}".encode())

    def rebuilt(ready):
        v = driver.world_version
        for host, lr in ready:
            driver.record_ready(host, lr)
        assert wait_until(lambda: driver.world_version > v and
                          not driver.resume_needed())
        advertise()
        trail.append(world())

    try:
        driver.start(4, lambda s: started.append(s.to_response_string()))
        advertise()
        trail.append(world())
        # b:1 crashes: its first strike is free, the slot is relaunched
        driver.record_worker_exit("b", 1, exit_code=1)
        rebuilt([("a", 0), ("a", 1), ("b", 0)])
        # b:1 crashes again: suspended with backoff, the world shrinks
        driver.record_worker_exit("b", 1, exit_code=1)
        rebuilt([("a", 0), ("a", 1), ("b", 0)])
        # host b leaves discovery: the workers hear REMOVED, and b:0,
        # whose host is gone, dies: b is blacklisted
        disc.set({"a": 2})
        assert wait_until(driver.resume_needed, timeout=5)
        assert wait_until(lambda: len(notes) >= 3, timeout=5)
        driver.record_worker_exit("b", 0, exit_code=1)
        rebuilt([("a", 0), ("a", 1)])
        trail.append({"b0": driver.get_slot_state("b", 0)[0],
                      "notes": sorted(set(notes))})
        # a:1 dies while b is gone: a:1's first strike, the world holds
        driver.record_worker_exit("a", 1, exit_code=1)
        rebuilt([("a", 0)])
    finally:
        driver.stop()
        server.stop()
    # a timeout below min_np
    server = rdv_mod.ElasticRendezvousServer()
    server.start()
    try:
        short = drv_mod.ElasticDriver(server, disc_mod.FixedHosts({"a": 1}),
                                      min_np=2, timeout=1.0)
        server.set_driver(short)
        with pytest.raises(TimeoutError) as ei:
            short.start(2, lambda s: None)
        trail.append({"timeout": str(ei.value)})
    finally:
        short.stop()
        server.stop()
    return trail


def test_driver_decisions_match_the_reference(monkeypatch):
    got = _script("port", monkeypatch)
    want = _script("ref", monkeypatch)
    assert got == want
    # the sequence went where it should: b blacklisted, a world of 2
    assert got[-2]["blacklist"] == ["b"]
    assert len(got[-2]["slots"]) == 2


ARGVS = [
    ["-np", "4", "python", "train.py"],
    ["-np", "2", "-H", "h1:2,h2:2", "--fusion-threshold-mb", "32",
     "--cycle-time-ms", "0", "--timeline-filename", "/tmp/t.json",
     "--timeline-mark-cycles", "--no-stall-check", "python", "train.py"],
    ["--min-np", "2", "--max-np", "4", "--host-discovery-script",
     "./hosts.sh", "--slots-per-host", "2", "--reset-limit", "3",
     "--autotune", "--autotune-log-file", "/tmp/a.csv",
     "--stall-check-warning-time-seconds", "30",
     "--stall-check-shutdown-time-seconds", "90", "--cache-capacity", "8",
     "--", "python", "train.py", "--lr", "0.1"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["static", "tuning", "elastic"])
def test_launcher_env_matches_the_reference(argv):
    from horovod_tpu.runner import launch as R
    from horovod_tpu.elastic import launcher as RE
    from horovod_tpu_torch.runner import launch as P
    from horovod_tpu_torch.elastic import launcher as PE
    from horovod_tpu_torch.runner.hosts import get_host_assignments, \
        parse_hosts
    from horovod_tpu.runner.hosts import get_host_assignments as rga
    from horovod_tpu.runner.hosts import parse_hosts as rph
    ra, pa = R.parse_args(argv), P.parse_args(argv)
    assert vars(ra) == {k: v for k, v in vars(pa).items() if k != "elastic"}
    assert R.env_from_args(ra) == P.env_from_args(pa)
    hosts = "h1:2,h2:2"
    slots = get_host_assignments(parse_hosts(hosts), 4, 4)
    rslots = rga(rph(hosts), 4, 4)
    assert [s.to_response_string() for s in slots] == \
        [s.to_response_string() for s in rslots]
    base = {"PATH": "/bin", "HOROVOD_FUSION_THRESHOLD": "1"}
    for s, r in zip(slots, rslots):
        for elastic in (False, True):
            assert P.make_worker_env(s, "@rendezvous", "10.0.0.1", 4321,
                                     base_env=base, elastic=elastic) == \
                R.make_worker_env(r, "@rendezvous", "10.0.0.1", 4321,
                                  base_env=base, elastic=elastic)
        assert PE.make_elastic_worker_env(s, "10.0.0.1", 4321, base) == \
            RE.make_elastic_worker_env(r, "10.0.0.1", 4321, base)


def test_launcher_elastic_flag_and_lazy_yaml(tmp_path):
    """``--elastic`` names the elastic launch; ``--config-file`` reads its
    YAML only when given (the card's machine has no yaml)."""
    import sys
    from horovod_tpu_torch.runner import launch as P
    assert P.parse_args(["--elastic", "-np", "1", "python", "x.py"]).elastic
    had_yaml = "yaml" in sys.modules
    P.parse_args(["-np", "1", "python", "x.py"])
    assert ("yaml" in sys.modules) == had_yaml
    cfg = tmp_path / "c.yaml"
    cfg.write_text("fusion-threshold-mb: 16\nelastic:\n  reset-limit: 2\n")
    args = P.parse_args(["--config-file", str(cfg), "-np", "2",
                         "--fusion-threshold-mb", "8", "python", "x.py"])
    assert args.fusion_threshold_mb == 8.0 and args.reset_limit == 2
