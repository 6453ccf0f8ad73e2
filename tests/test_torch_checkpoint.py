"""horovod_tpu_torch's durable checkpointing (``checkpoint/``) and the
rendezvous KV it writes through (``runner/``), against the JAX package's.

The reference's ``tests/test_checkpoint.py`` classes (``TestShardIO``,
``TestManifest``, ``TestManager``, ``TestKVTransfer``) run here on torch
trees at the same sizes. Across packages: a generation the reference writes
restores in the port bitwise, and one the port writes (a bf16 leaf, dict,
OrderedDict and tuple included) restores in the reference bitwise, with the
shard bytes and headers equal; both packages' ``zero1_reshard`` agree on a
ZeRO-1 generation that a 2-rank gloo world wrote through
``checkpoint_payload()``; the port's tree flattening takes
``jax.tree_util``'s leaf order. Gloo worlds (``torch_worker.py``'s ``ckpt``
scenario, np=2) snapshot through the engine's step hook, on a shared disk
and through a test-started ``KVStoreServer``; their generations restore at
np=1 bitwise from disk with one rank's directory gone, and from the KV
alone. Every comparison is bitwise: a checkpoint moves bytes.
"""

import collections
import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import jax
from horovod_tpu import faults as ref_faults
from horovod_tpu.checkpoint import CheckpointManager as RefManager
from horovod_tpu.checkpoint import shard_io as ref_shard_io
from horovod_tpu.models import transformer as JT

import horovod_tpu_torch as hvd
from horovod_tpu_torch import faults
from horovod_tpu_torch.checkpoint import (CheckpointManager,
                                          CheckpointRestoreError,
                                          build_manifest, checksum, flatten,
                                          generation_complete,
                                          load_training_state,
                                          reshard_ranges, training_state,
                                          training_template,
                                          validate_manifest, zero1_reshard)
from horovod_tpu_torch.checkpoint import manifest as mf
from horovod_tpu_torch.checkpoint import shard_io
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.metrics import registry
from horovod_tpu_torch.models.convert import transformer_from_jax
from horovod_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)
from horovod_tpu_torch.runner.http_server import KVStoreServer
from torch_worker import (CKPT_STEPS, CKPT_ZERO1_STEPS, SHARDED_THRESHOLD,
                          World, ckpt_model_and_opt, ckpt_numpy,
                          sharded_data)


@pytest.fixture(autouse=True)
def _disarm():
    faults.disarm()
    ref_faults.disarm()
    yield
    faults.disarm()
    ref_faults.disarm()


def _tree(seed=0, kb=4):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.rand(kb * 64, 4, generator=g),
            "b": torch.rand(7, generator=g),
            "n": torch.tensor(3, dtype=torch.int32)}


def _write_world(d, tree, n, step=1, redundancy=1, kv=None, extras=None,
                 cls=CheckpointManager):
    mgrs = [cls(d, rank=r, world_size=n, redundancy=redundancy, kv=kv)
            for r in range(n)]
    try:
        for m in mgrs:
            assert m.snapshot(tree, step=step, extras=extras)
        for m in mgrs:
            assert m.wait_idle(60)
    finally:
        for m in mgrs:
            m.close(flush=False)
    return mgrs


def _assert_leaves_equal(got, want):
    got, want = flatten(got)[0], flatten(want)[0]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.cpu() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.cpu() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert shard_io.dtype_name(a.dtype) == shard_io.dtype_name(b.dtype)
        assert shard_io.leaf_bytes(a).tobytes() == \
            shard_io.leaf_bytes(b).tobytes()


def _as_numpy(tree):
    """The tree with every tensor a numpy array (bf16 as ml_dtypes'), the
    structure kept: what the reference's side holds."""
    leaves, rebuild = flatten(tree)

    def conv(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(jax.numpy.bfloat16)
        return x.numpy()
    return rebuild([conv(x) for x in leaves])


# ---------------------------------------------------------------------------
# shard_io: the flat-stream layout + N→M re-slice math
# ---------------------------------------------------------------------------

class TestShardIO:
    def test_encode_decode_round_trip(self):
        leaves = flatten(_tree())[0]
        header = shard_io.make_header(leaves, step=1, world_version=0,
                                      world_size=4)
        stream = shard_io.encode_leaves(leaves)
        assert len(stream) == header["total_bytes"]
        out = shard_io.decode_leaves(stream, header)
        for a, b in zip(leaves, out):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def test_shards_cover_stream_with_padding(self):
        stream = bytes(range(256)) * 3  # 768 bytes
        for n in (1, 2, 3, 5, 7):
            shards = [shard_io.shard_of(stream, r, n) for r in range(n)]
            assert len({len(s) for s in shards}) == 1
            joined = b"".join(shards)
            assert joined[:len(stream)] == stream
            assert set(joined[len(stream):]) <= {0}

    @pytest.mark.parametrize("old_n,new_n", [(4, 2), (2, 4), (4, 1),
                                             (1, 4), (3, 5), (5, 3)])
    def test_reshard_ranges_exact(self, old_n, new_n):
        stream = os.urandom(1037)
        old = [shard_io.shard_of(stream, r, old_n) for r in range(old_n)]
        rebuilt = b""
        for nr in range(new_n):
            for old_rank, off, length in reshard_ranges(
                    len(stream), old_n, nr, new_n):
                rebuilt += old[old_rank][off:off + length]
        assert rebuilt == stream
        assert [reshard_ranges(len(stream), old_n, nr, new_n)
                for nr in range(new_n)] == \
            [ref_shard_io.reshard_ranges(len(stream), old_n, nr, new_n)
             for nr in range(new_n)]

    def test_zero1_state_bucket_assignment(self):
        buckets = [{"shard": 5}, {"shard": 5}, {"shard": 3}]
        leaves = [torch.zeros(()),
                  torch.zeros(5), torch.zeros(5), torch.zeros(3),
                  torch.zeros(5), torch.zeros(5), torch.zeros(3)]
        got = shard_io._assign_state_buckets(leaves, buckets)
        assert got == [None, 0, 1, 2, 0, 1, 2]

    def test_zero1_reshard_parity(self):
        """N=3 → M=2: reassembled full buckets equal the logical flat
        params, and the new shards re-slice them exactly (the moments
        included), equal to the reference's reshard of the same
        payloads."""
        layout = [((0, 1), (10, 7), 17, 6), ((2,), (7,), 7, 3)]
        rng = np.random.RandomState(1)
        full0 = rng.rand(18).astype(np.float32)
        full1 = rng.rand(9).astype(np.float32)
        full0[17:] = 0
        full1[7:] = 0
        mu0, mu1 = rng.rand(18).astype(np.float32), \
            rng.rand(9).astype(np.float32)
        payloads, header, ref_header = {}, None, None
        for r in range(3):
            shards = [torch.from_numpy(full0[r * 6:(r + 1) * 6]),
                      torch.from_numpy(full1[r * 3:(r + 1) * 3])]
            state = [torch.tensor(2, dtype=torch.int32),
                     torch.from_numpy(mu0[r * 6:(r + 1) * 6]),
                     torch.from_numpy(mu1[r * 3:(r + 1) * 3])]
            header = shard_io.zero1_header(layout, shards, state, step=2,
                                           world_version=1, world_size=3)
            ref_header = ref_shard_io.zero1_header(
                layout, [s.numpy() for s in shards],
                [s.numpy() for s in state], step=2, world_version=1,
                world_size=3)
            payloads[r] = shard_io.zero1_payload(shards, state)
            assert payloads[r] == ref_shard_io.zero1_payload(
                [s.numpy() for s in shards], [s.numpy() for s in state])
        assert json.dumps(header) == json.dumps(ref_header)
        for new_rank in range(2):
            re = zero1_reshard(header, payloads, new_rank, 2)
            ref = ref_shard_io.zero1_reshard(header, payloads, new_rank, 2)
            np.testing.assert_array_equal(re["full_buckets"][0].numpy(),
                                          full0[:17])
            np.testing.assert_array_equal(re["full_buckets"][1].numpy(),
                                          full1[:7])
            assert re["shards"][0].shape == (9,)
            pad0 = np.concatenate([full0[:17], np.zeros(1, np.float32)])
            np.testing.assert_array_equal(
                re["shards"][0].numpy(), pad0[new_rank * 9:(new_rank + 1) * 9])
            for key in ("shards", "state_leaves", "full_buckets"):
                for a, b in zip(re[key], ref[key]):
                    np.testing.assert_array_equal(a.numpy(), b)

    @pytest.mark.parametrize("new_n", [1, 3])
    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_zero1_reshard_maps_split_buckets_of_one_shard_size(
            self, writer, new_n):
        """Three buckets of totals [10, 4, 9] over 2 ranks (shards [5, 2,
        5]) with AdamW's state (count, mu[0..2], nu[0..2]): the header maps
        the moments to buckets [0, 1, 0] and [2, 1, 0], restarting its
        count at each change of shard size. The port's reader maps them to
        [0, 1, 2] twice, so every moment comes back as its bucket's logical
        vector (lengths 10, 4, 9) from either package's generation.

        The reference's reader keeps the header's map: resharded 2 → 1 its
        mu/nu come back with lengths [10, 4, 10] and [9, 4, 10]; 2 → 3
        with per-rank shards [4, 2, 4] and [3, 2, 4] where [4, 2, 3] are
        right."""
        totals, n = [10, 4, 9], 2
        shards = [-(-t // n) for t in totals]
        layout = [((b,), (t,), t, s)
                  for b, (t, s) in enumerate(zip(totals, shards))]
        rng = np.random.RandomState(3)

        def padded(t, s):
            v = np.zeros(s * n, np.float32)
            v[:t] = rng.rand(t)
            return v
        params = [padded(t, s) for t, s in zip(totals, shards)]
        mu = [padded(t, s) for t, s in zip(totals, shards)]
        nu = [padded(t, s) for t, s in zip(totals, shards)]
        payloads, header = {}, None
        for r in range(n):
            part = [[v[r * s:(r + 1) * s] for v, s in zip(vs, shards)]
                    for vs in (params, mu, nu)]
            state = [np.array(7, np.int32)] + part[1] + part[2]
            if writer == "port":
                header = shard_io.zero1_header(
                    layout, [torch.from_numpy(a) for a in part[0]],
                    [torch.from_numpy(a) for a in state], step=7,
                    world_version=0, world_size=n)
                payloads[r] = shard_io.zero1_payload(
                    [torch.from_numpy(a) for a in part[0]],
                    [torch.from_numpy(a) for a in state])
            else:
                header = ref_shard_io.zero1_header(
                    layout, part[0], state, step=7, world_version=0,
                    world_size=n)
                payloads[r] = ref_shard_io.zero1_payload(part[0], state)
        assert [m["bucket"] for m in header["state_leaves"]] == \
            [None, 0, 1, 0, 2, 1, 0]
        got = [zero1_reshard(header, payloads, nr, new_n)
               for nr in range(new_n)]
        ref = [ref_shard_io.zero1_reshard(header, payloads, nr, new_n)
               for nr in range(new_n)]
        new_shards = [-(-t // new_n) for t in totals]
        wrong = {1: [[10, 4, 10], [9, 4, 10]],
                 3: [[4, 2, 4], [3, 2, 4]]}[new_n]
        assert int(got[0]["state_leaves"][0]) == 7
        for k, vs in ((0, mu), (1, nu)):
            for b, (t, s) in enumerate(zip(totals, new_shards)):
                j = 1 + 3 * k + b
                assert [g["state_leaves"][j].shape[0] for g in got] == \
                    [s] * new_n
                assert ref[0]["state_leaves"][j].shape[0] == wrong[k][b]
                joined = torch.cat([g["state_leaves"][j] for g in got])
                np.testing.assert_array_equal(joined[:t].numpy(), vs[b][:t])
                assert not joined[t:].any()
        for g, want in zip(got[0]["full_buckets"], params):
            assert g.numel() in totals
            np.testing.assert_array_equal(g.numpy(), want[:g.numel()])

    def test_zero1_reshard_missing_rank_raises(self):
        layout = [((0,), (4,), 4, 2)]
        shards = [torch.arange(2, dtype=torch.float32)]
        header = shard_io.zero1_header(layout, shards, [], step=1,
                                       world_version=0, world_size=2)
        with pytest.raises(ValueError, match="missing"):
            zero1_reshard(header, {0: shard_io.zero1_payload(shards, [])},
                          0, 1)

    def test_bf16_and_scalar_leaves_are_the_references_bytes(self):
        """A bf16 leaf goes down as its raw words with dtype "bfloat16";
        the stream and the header are the reference's for the same values
        (ml_dtypes' bf16 there), and decode to torch.bfloat16 bitwise."""
        g = torch.Generator().manual_seed(4)
        tree = {"h": torch.randn(5, 3, generator=g).to(torch.bfloat16),
                "f": torch.randn(4, generator=g, dtype=torch.float64),
                "m": torch.tensor([True, False]), "s": 2.5, "i": 7,
                "k": np.int32(3)}
        leaves = flatten(tree)[0]
        ref_leaves = [np.asarray(x) for x in
                      jax.tree_util.tree_leaves(_as_numpy(tree))]
        stream = shard_io.encode_leaves(leaves)
        assert stream == ref_shard_io.encode_leaves(ref_leaves)
        staged = [shard_io.LeafSpec(tuple(np.shape(x)),
                                    shard_io.dtype_name(
                                        x.dtype if isinstance(x, torch.Tensor)
                                        else np.asarray(x).dtype),
                                    len(shard_io.leaf_bytes(x)))
                  for x in leaves]
        header = shard_io.make_header(staged, step=3, world_version=2,
                                      world_size=3, extras={"e": 1})
        ref_header = ref_shard_io.make_header(
            ref_leaves, step=3, world_version=2, world_size=3,
            extras={"e": 1})
        assert json.dumps(header) == json.dumps(ref_header)
        assert [m["dtype"] for m in header["leaves"]] == \
            ["float64", "bfloat16", "int64", "int32", "bool", "float64"]
        out = shard_io.decode_leaves(stream, header)
        assert out[1].dtype == torch.bfloat16
        assert torch.equal(out[1], tree["h"])
        for a, b in zip(ref_shard_io.decode_leaves(stream, ref_header), out):
            assert a.tobytes() == shard_io.leaf_bytes(b).tobytes()


# ---------------------------------------------------------------------------
# manifests + commit barrier
# ---------------------------------------------------------------------------

class TestManifest:
    def _man(self, rank, n=2, step=1, wv=0, digest="d" * 8, cs=None):
        cs = cs or {rank: "a" * 64}
        return build_manifest(rank, step=step, world_version=wv,
                              world_size=n, layout_digest=digest,
                              shard_checksums=cs,
                              shard_bytes={k: 10 for k in cs},
                              holds=list(cs))

    def test_schema_round_trip(self):
        m = json.loads(json.dumps(self._man(0)))
        assert validate_manifest(m) == []
        assert checksum(b"abc") == hashlib.sha256(b"abc").hexdigest()

    def test_schema_rejects(self):
        m = self._man(0)
        del m["layout_digest"]
        assert any("layout_digest" in e for e in validate_manifest(m))
        m = self._man(0)
        m["shard_checksums"] = {"0": "nothex"}
        assert any("sha256" in e for e in validate_manifest(m))
        m = self._man(1, n=1)
        assert any("outside world" in e for e in validate_manifest(m))

    def test_barrier_complete_and_stale_wv(self):
        mans = {0: self._man(0), 1: self._man(1, cs={1: "b" * 64})}
        ok, errs = generation_complete(mans)
        assert ok, errs
        mans[1]["world_version"] = 7
        ok, errs = generation_complete(mans)
        assert not ok and any("stale world_version" in e for e in errs)

    def test_barrier_partial_and_checksum_mismatch(self):
        ok, errs = generation_complete({0: self._man(0)})
        assert not ok and any("missing manifests" in e for e in errs)
        mans = {0: self._man(0, cs={0: "a" * 64, 1: "c" * 64}),
                1: self._man(1, cs={1: "b" * 64})}
        ok, errs = generation_complete(mans)
        assert not ok and any("checksum mismatch" in e for e in errs)

    def test_restorable_covers_lost_host(self):
        mans = {0: self._man(0, cs={0: "a" * 64, 1: "b" * 64})}
        mans[0]["holds"] = [0, 1]
        ok, errs = mf.generation_restorable(mans)
        assert ok, errs
        ok, errs = mf.generation_restorable({0: self._man(0)})
        assert not ok and any("held by no surviving rank" in e
                              for e in errs)


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

class TestManager:
    def test_round_trip_with_template_and_extras(self, tmp_path):
        tree = _tree()
        _write_world(str(tmp_path), tree, n=3, step=4, extras={"batch": 9})
        m = CheckpointManager(str(tmp_path), rank=0, world_size=3)
        try:
            res = m.restore_latest(template=tree)
            assert res.step == 4 and res.mode == "replicated"
            assert res.extras == {"batch": 9}
            assert torch.equal(res.tree["w"], tree["w"])
            assert int(res.tree["n"]) == 3
            # without a template: the leaves, CPU tensors, in tree order
            raw = m.restore_latest().tree
            assert [t.dtype for t in raw] == [torch.float32, torch.int32,
                                              torch.float32]
        finally:
            m.close(flush=False)

    def test_snapshot_captures_values_not_references(self, tmp_path):
        """Torch tensors are mutable: a leaf written in place after
        snapshot() returns must not reach the generation."""
        tree = _tree()
        want = {k: v.clone() for k, v in tree.items()}
        faults.arm("checkpoint.write=1*delay(0.3)")
        m = CheckpointManager(str(tmp_path), rank=0, world_size=1)
        try:
            assert m.snapshot(tree, step=1)
            tree["w"].mul_(2.0)
            tree["n"].fill_(9)
            assert m.wait_idle(30)
            res = m.restore_latest(template=tree)
            _assert_leaves_equal(res.tree, want)
        finally:
            m.close(flush=False)

    def test_snapshot_is_async_and_double_buffered(self, tmp_path):
        reg = registry()
        skipped0 = reg.counter("hvd_tpu_ckpt_snapshots_total").value(
            outcome="skipped")
        faults.arm("checkpoint.write=1*delay(0.5)")
        m = CheckpointManager(str(tmp_path), rank=0, world_size=1)
        try:
            tree = _tree()
            t0 = time.perf_counter()
            for s in range(1, 6):
                m.snapshot(tree, step=s)
            stall = time.perf_counter() - t0
            assert stall < 0.3, f"snapshot() blocked the step path: {stall}"
            assert m.wait_idle(30)
            assert reg.counter("hvd_tpu_ckpt_snapshots_total").value(
                outcome="skipped") > skipped0
            assert m.last_written_step == 5
            stages = m.last_write_stages
            assert stages["bytes"] == sum(v.nbytes for v in tree.values())
            assert set(stages) == {"d2h", "encode", "checksum", "files",
                                   "replicas", "wall", "bytes"}
            assert stages["wall"] >= stages["checksum"] + stages["files"]
        finally:
            m.close(flush=False)

    def test_write_drop_failpoint_never_commits(self, tmp_path):
        reg = registry()
        failed0 = reg.counter("hvd_tpu_ckpt_snapshots_total").value(
            outcome="failed")
        faults.arm("checkpoint.write=1*drop()")
        m = CheckpointManager(str(tmp_path), rank=0, world_size=1)
        try:
            m.snapshot(_tree(), step=1)
            assert m.wait_idle(30)
            assert reg.counter("hvd_tpu_ckpt_snapshots_total").value(
                outcome="failed") == failed0 + 1
            assert m.latest_generation() is None
            with pytest.raises(CheckpointRestoreError):
                m.restore_latest()
            m.snapshot(_tree(), step=2)
            assert m.wait_idle(30)
            assert m.latest_generation()[0] == 2
        finally:
            m.close(flush=False)

    def test_restore_failpoint_surfaces(self, tmp_path):
        _write_world(str(tmp_path), _tree(), n=1)
        faults.arm("checkpoint.restore=1*raise(HorovodInternalError)")
        m = CheckpointManager(str(tmp_path), rank=0, world_size=1)
        try:
            with pytest.raises(HorovodInternalError):
                m.restore_latest()
            faults.disarm()
            assert m.restore_latest(template=_tree()).step == 1
        finally:
            m.close(flush=False)

    def test_peer_redundant_restore_disk(self, tmp_path):
        tree = _tree(kb=8)
        _write_world(str(tmp_path), tree, n=3)
        shutil.rmtree(tmp_path / "rank1")
        m = CheckpointManager(str(tmp_path), rank=0, world_size=3)
        try:
            res = m.restore_latest(template=tree)
            assert torch.equal(res.tree["w"], tree["w"])
        finally:
            m.close(flush=False)
        shutil.rmtree(tmp_path / "rank2")
        m = CheckpointManager(str(tmp_path), rank=0, world_size=3)
        try:
            with pytest.raises(CheckpointRestoreError):
                m.restore_latest(template=tree)
        finally:
            m.close(flush=False)

    def test_corrupt_replica_rejected(self, tmp_path):
        tree = _tree()
        _write_world(str(tmp_path), tree, n=2)
        shutil.rmtree(tmp_path / "rank1")
        path = tmp_path / "rank0" / "gen1" / "shard_1.bin"
        data = bytearray(path.read_bytes())
        data[0] ^= 0xFF
        path.write_bytes(bytes(data))
        m = CheckpointManager(str(tmp_path), rank=0, world_size=2)
        try:
            with pytest.raises(CheckpointRestoreError,
                               match="checksum mismatch"):
                m.restore_latest(template=tree)
        finally:
            m.close(flush=False)

    def test_template_mismatch_raises(self, tmp_path):
        tree = _tree()
        _write_world(str(tmp_path), tree, n=1)
        m = CheckpointManager(str(tmp_path), rank=0, world_size=1)
        try:
            bad = dict(tree, w=torch.zeros(3, 4))
            with pytest.raises(CheckpointRestoreError, match="shape"):
                m.restore_latest(template=bad)
            bad = dict(tree, b=tree["b"].double())
            with pytest.raises(CheckpointRestoreError, match="dtype"):
                m.restore_latest(template=bad)
            with pytest.raises(CheckpointRestoreError, match="leaves"):
                m.restore_latest(template={"w": tree["w"]})
        finally:
            m.close(flush=False)

    def test_reshard_restore_n4_to_n2_and_slice(self, tmp_path):
        tree = _tree(seed=3)
        _write_world(str(tmp_path), tree, n=4)
        stream = shard_io.encode_leaves(flatten(tree)[0])
        for new_n in (2, 1):
            m = CheckpointManager(str(tmp_path), rank=0, world_size=new_n)
            try:
                res = m.restore_latest(template=tree)
                _assert_leaves_equal(res.tree, tree)
                joined = b"".join(m.restore_shard_slice(r, new_n)
                                  for r in range(new_n))
                assert joined[:len(stream)] == stream
            finally:
                m.close(flush=False)

    def test_gc_keeps_newest_and_drops_partials(self, tmp_path):
        reg = registry()
        gc0 = reg.counter("hvd_tpu_ckpt_gc_total").total()
        m = CheckpointManager(str(tmp_path), rank=0, world_size=1, keep=2)
        try:
            partial = tmp_path / "rank0" / "gen1"
            partial.mkdir(parents=True)
            (partial / "shard_0.bin").write_bytes(b"junk")
            for s in (2, 3, 4):
                m.snapshot(_tree(seed=s), step=s)
                assert m.wait_idle(30)
            gens = sorted(os.listdir(tmp_path / "rank0"))
            assert gens == ["gen3", "gen4"], gens
            assert reg.counter("hvd_tpu_ckpt_gc_total").total() > gc0
        finally:
            m.close(flush=False)

    def test_training_state_resumes_bitwise(self, tmp_path):
        """A model and AdamW snapshotted mid-run restore into a fresh pair
        through training_template/load_training_state, and the resumed
        steps are the uninterrupted run's bitwise."""
        x = torch.from_numpy(sharded_data()[0])

        def step(model, opt):
            opt.zero_grad()
            model(x).square().mean().backward()
            opt.step()

        model, opt = ckpt_model_and_opt(hvd, "cpu")
        for _ in range(2):
            step(model, opt.optimizer)
        m = CheckpointManager(str(tmp_path), rank=0, world_size=1)
        try:
            assert m.snapshot(training_state(model, opt), step=2)
            assert m.wait_idle(30)
            fresh, fopt = ckpt_model_and_opt(hvd, "cpu")
            res = m.restore_latest(template=training_template(fresh, fopt))
            load_training_state(res.tree, fresh, fopt)
        finally:
            m.close(flush=False)
        want = ckpt_numpy(training_state(model, opt))
        got = ckpt_numpy(training_state(fresh, fopt))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
        assert fopt.optimizer.param_groups[0]["lr"] == \
            opt.optimizer.param_groups[0]["lr"]
        for _ in range(2):
            step(model, opt.optimizer)
            step(fresh, fopt.optimizer)
        for a, b in zip(model.parameters(), fresh.parameters()):
            assert torch.equal(a, b)

    def test_restore_timeline_in_trace_ring(self, tmp_path):
        from horovod_tpu_torch.trace import TraceRecorder, merge_segments
        rec = TraceRecorder(rank=0, capacity=256)
        rec.add_beacon(0.0, 1000.0, 0.001)
        m = CheckpointManager(str(tmp_path), rank=0, world_size=1,
                              trace=rec)
        try:
            m.snapshot(_tree(), step=3)
            assert m.wait_idle(30)
            m.restore_latest(template=_tree())
        finally:
            m.close(flush=False)
        events = merge_segments({0: rec.segment()})
        for nm in ("ckpt.write.g3", "ckpt.restore.g3"):
            phs = [e["ph"] for e in events
                   if str(e.get("args", {}).get("corr", ""))
                   .startswith(nm + "#")]
            assert phs.count("B") == 1 and phs.count("E") == 1, (nm, events)
        assert any(e.get("name") == "CHECKPOINT" for e in events)


class TestWired:
    """The manager GlobalState builds from the knobs, and the ZeRO-1
    payload of DistributedOptimizer(sharded=True), in this process's
    size-1 world."""

    @pytest.fixture
    def ckpt_world(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HOROVOD_TPU_CHECKPOINT_DIR", str(tmp_path))
        monkeypatch.setenv("HOROVOD_TPU_CHECKPOINT_KEEP", "3")
        hvd.shutdown()
        hvd.init(device="cpu")
        yield tmp_path
        hvd.shutdown()

    def test_interval_hook_snapshots_provider(self, ckpt_world):
        gs = hvd.global_state()
        mgr = gs.checkpoint_manager
        assert mgr is not None and mgr.keep == 3 and gs.kv is None
        assert gs.engine.on_step_complete == mgr.on_step
        mgr.interval_steps = 2
        tick = {"n": 0}

        def provider():
            tick["n"] += 1
            return {"x": np.arange(3, dtype=np.float32)}, tick["n"]

        mgr.register_provider(provider)
        for _ in range(4):
            with hvd.step():
                pass
        assert mgr.wait_idle(30)
        assert tick["n"] == 2
        assert mgr.latest_generation()[0] == 2
        # a provider that raises is logged; the step goes on
        mgr.register_provider(lambda: 1 / 0)
        hvd.step_begin()
        hvd.step_end()
        hvd.step_begin()
        hvd.step_end()

    def test_zero1_payload_round_trip(self, ckpt_world, monkeypatch):
        """checkpoint_payload() → snapshot_zero1 → restore_latest →
        restore_from_durable into a fresh sharded optimizer that has not
        stepped: parameters, shards and moments bitwise, and the next
        step bitwise the uninterrupted one."""
        hvd.global_state().config.fusion_threshold_bytes = SHARDED_THRESHOLD
        x, y = (torch.from_numpy(a) for a in sharded_data())

        def step(model, opt):
            opt.zero_grad()
            ((model(x) - y) ** 2).mean().backward()
            opt.step()

        model, opt = ckpt_model_and_opt(hvd, "cpu", sharded=True)
        with pytest.raises(ValueError, match="first sharded step"):
            opt.checkpoint_payload()
        for _ in range(2):
            step(model, opt)
        shards, leaves, layout = opt.checkpoint_payload()
        assert [tuple(l.shape) for l in leaves] == \
            [()] + [tuple(s.shape) for s in shards] * 2
        assert leaves[0].dtype == torch.int32 and int(leaves[0]) == 2
        mgr = hvd.global_state().checkpoint_manager
        assert mgr.snapshot_zero1(shards, leaves, layout, step=2)
        assert mgr.wait_idle(30)
        res = mgr.restore_latest()
        assert res.mode == "zero1"
        fresh, fopt = ckpt_model_and_opt(hvd, "cpu", sharded=True)
        fopt.restore_from_durable(res.tree)
        for a, b in zip(model.parameters(), fresh.parameters()):
            assert torch.equal(a, b)
        got = fopt.checkpoint_payload()
        for a, b in zip(shards + leaves, got[0] + got[1]):
            assert torch.equal(a, b)
        step(model, opt)
        step(fresh, fopt)
        for a, b in zip(model.parameters(), fresh.parameters()):
            assert torch.equal(a, b)
        # another layout is refused with the reference's message
        hvd.global_state().config.fusion_threshold_bytes = 64
        other, oopt = ckpt_model_and_opt(hvd, "cpu", sharded=True)
        with pytest.raises(ValueError, match="bucket layout does not match"):
            oopt.restore_from_durable(res.tree)


# ---------------------------------------------------------------------------
# chunked large-value KV transfer + KV-backed peer restore
# ---------------------------------------------------------------------------

class TestKVTransfer:
    @pytest.fixture
    def kv_server(self):
        server = KVStoreServer(("127.0.0.1", 0))
        server.start()
        yield server
        faults.disarm()
        server.stop()

    def test_chunked_round_trip_and_delete(self, kv_server):
        from horovod_tpu_torch.runner.http_client import (
            delete_large_value, put_large_value, read_large_value)
        kv = ("127.0.0.1", kv_server.port)
        value = os.urandom(300_000)
        n = put_large_value(*kv, "ckptshard", "g1.r0", value,
                            chunk_bytes=65536)
        assert n == 5
        assert read_large_value(*kv, "ckptshard", "g1.r0",
                                timeout=10) == value
        delete_large_value(*kv, "ckptshard", "g1.r0")
        with pytest.raises(TimeoutError):
            read_large_value(*kv, "ckptshard", "g1.r0", timeout=0.5)
        assert not kv_server.snapshot().get("ckptshard")
        # five chunks and the meta record, counted by the server
        puts, nbytes = kv_server.request_stats()[("put", "ckptshard")]
        assert puts == 6 and nbytes > len(value)

    def test_read_retries_torn_write(self, kv_server):
        from horovod_tpu_torch.runner.http_client import (
            put_data_into_kvstore, put_large_value, read_large_value)
        kv = ("127.0.0.1", kv_server.port)
        value = os.urandom(100_000)
        meta = {"chunks": 2, "bytes": len(value),
                "sha256": hashlib.sha256(value).hexdigest(),
                "chunk_bytes": 65536}
        put_data_into_kvstore(*kv, "ckptshard", "k.c0", value[:65536])
        put_data_into_kvstore(*kv, "ckptshard", "k",
                              json.dumps(meta).encode())

        def _complete():
            time.sleep(0.3)
            put_large_value(*kv, "ckptshard", "k", value,
                            chunk_bytes=65536)

        t = threading.Thread(target=_complete)
        t.start()
        try:
            assert read_large_value(*kv, "ckptshard", "k",
                                    timeout=10) == value
        finally:
            t.join()

    def test_kv_only_restore_after_downsize(self, kv_server, tmp_path):
        kv = ("127.0.0.1", kv_server.port)
        tree = _tree(seed=6)
        _write_world(str(tmp_path), tree, n=3, kv=kv)
        m = CheckpointManager(str(tmp_path / "private"), rank=0,
                              world_size=1, kv=kv)
        try:
            res = m.restore_latest(template=tree)
            assert torch.equal(res.tree["w"], tree["w"]) and res.step == 1
        finally:
            m.close(flush=False)

    def test_kv_mediated_peer_restore(self, kv_server, tmp_path):
        kv = ("127.0.0.1", kv_server.port)
        tree = _tree(seed=5)
        _write_world(str(tmp_path), tree, n=2, kv=kv)
        kv_server.clear_all()
        shutil.rmtree(tmp_path / "rank1")
        m0 = CheckpointManager(str(tmp_path), rank=0, world_size=2, kv=kv)
        m1 = CheckpointManager(str(tmp_path / "lonely"), rank=1,
                               world_size=2, kv=kv, kv_timeout=15.0)
        try:
            res0 = m0.restore_latest(template=tree)
            assert torch.equal(res0.tree["w"], tree["w"])
            res1 = m1.restore_latest(template=tree)
            assert torch.equal(res1.tree["w"], tree["w"])
        finally:
            m0.close(flush=False)
            m1.close(flush=False)

    def test_server_failpoints_and_replication_not_ported(self, kv_server):
        from horovod_tpu_torch.runner.http_client import (
            put_data_into_kvstore, read_data_from_kvstore)
        kv = ("127.0.0.1", kv_server.port)
        faults.arm("kv.server.put=1*drop()")
        put_data_into_kvstore(*kv, "s", "k", b"lost")
        assert kv_server.snapshot().get("s") is None
        put_data_into_kvstore(*kv, "s", "k", b"kept")
        assert read_data_from_kvstore(*kv, "s", "k", timeout=5) == b"kept"
        # replication is ported now: a one-replica set is its own primary
        # and journals the store's writes from here on
        self_addr = f"127.0.0.1:{kv_server.port}"
        repl = kv_server.enable_replication(self_addr, [self_addr],
                                            role="primary")
        assert kv_server.replication is repl
        assert repl.status()["role"] == "primary"
        put_data_into_kvstore(*kv, "s", "k2", b"journaled")
        assert read_data_from_kvstore(*kv, "s", "k2", timeout=5) == \
            b"journaled"
        assert repl.audit_journal()["entries"] == 1


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

LM_DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
               max_seq=16)


@pytest.mark.parametrize("tree", [
    {"b": 1, "a": [2, None, (3, 4)], "c": {"z": 5, "y": 6}},
    collections.OrderedDict([("z", 1), ("a", {"q": 2, "p": 3})]),
    [collections.namedtuple("NT", "y x")(1, 2), {3: 4, 1: 5}],
    (None, {"k": collections.defaultdict(list, {"b": 1, "a": 2})})],
    ids=["dict", "ordered", "namedtuple", "defaultdict"])
def test_flatten_takes_jax_leaf_order(tree):
    leaves, rebuild = flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    assert jax.tree_util.tree_structure(rebuild(leaves)) == \
        jax.tree_util.tree_structure(tree)


def test_reference_generation_restores_in_the_port(tmp_path):
    """The reference writes a tiny decoder LM's parameters (its own
    init_params tree, numpy) at world 2 as two managers in this process;
    the port restores the generation at world 1 bitwise, into the numpy
    tree and through transformer_from_jax into its Transformer."""
    cfg = JT.TransformerConfig(dtype=jax.numpy.float32, **LM_DIMS)
    params = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jax.random.PRNGKey(3), cfg))
    _write_world(str(tmp_path), {"params": params, "step": np.int32(7)},
                 n=2, step=7, extras={"batch": 7}, cls=RefManager)
    m = CheckpointManager(str(tmp_path), rank=0, world_size=1)
    try:
        res = m.restore_latest(template={"params": params,
                                         "step": np.int32(7)})
        raw = m.restore_latest().tree
    finally:
        m.close(flush=False)
    assert res.step == 7 and res.extras == {"batch": 7}
    for a, b in zip(jax.tree_util.tree_leaves(res.tree["params"]),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert [t.numpy().tobytes() for t in raw] == \
        [np.asarray(x).tobytes() for x in jax.tree_util.tree_leaves(
            {"params": params, "step": np.int32(7)})]
    port_cfg = TransformerConfig(dtype=torch.float32, attention="flash",
                                 **LM_DIMS)
    model = Transformer(port_cfg)
    model.load_state_dict(transformer_from_jax(res.tree["params"], port_cfg))
    want = transformer_from_jax(params, port_cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_port_generation_restores_in_the_reference(tmp_path):
    """The port writes a tree of an OrderedDict (a Transformer's
    state_dict with a bf16 copy of a weight), a tuple, a dict and a Python
    scalar at world 2; every shard file is the reference's bytes for the
    same values, and the reference restores the generation at world 1
    bitwise."""
    port_cfg = TransformerConfig(dtype=torch.float32, attention="flash",
                                 **LM_DIMS)
    model = Transformer(port_cfg,
                        generator=torch.Generator().manual_seed(2))
    sd = model.state_dict()
    sd["embed_bf16"] = sd["embed"].to(torch.bfloat16)
    tree = {"model": sd, "aux": (torch.arange(5), {"z": torch.ones(2, 3),
                                                   "a": np.float32(0.5)}),
            "lr": 3e-4}
    _write_world(str(tmp_path), tree, n=2, step=5, extras={"k": "v"})
    ref_tree = _as_numpy(tree)
    ref_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_tree)]
    stream = ref_shard_io.encode_leaves(ref_leaves)
    ref_header = ref_shard_io.make_header(ref_leaves, step=5,
                                          world_version=0, world_size=2,
                                          extras={"k": "v"})
    for r in range(2):
        gdir = tmp_path / f"rank{r}" / "gen5"
        assert (gdir / f"shard_{r}.bin").read_bytes() == \
            ref_shard_io.shard_of(stream, r, 2)
        assert json.loads((gdir / "header.json").read_text()) == ref_header
    m = RefManager(str(tmp_path), rank=0, world_size=1)
    try:
        res = m.restore_latest(template=ref_tree)
    finally:
        m.close(flush=False)
    assert res.step == 5 and res.extras == {"k": "v"}
    got = jax.tree_util.tree_leaves(res.tree)
    assert len(got) == len(ref_leaves)
    for a, b in zip(got, ref_leaves):
        assert str(a.dtype) == str(b.dtype) and a.tobytes() == b.tobytes()
    assert isinstance(res.tree["model"], collections.OrderedDict)
    assert list(res.tree["model"]) == list(sd)


# ---------------------------------------------------------------------------
# np=2 gloo worlds: the engine's step hook, disk and KV
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_worlds(tmp_path_factory):
    """The ckpt scenario at np=2 twice, started together: on a shared
    disk (with the ZeRO-1 part), and with a KVStoreServer named through
    HOROVOD_GLOO_RENDEZVOUS_ADDR/_PORT."""
    out = tmp_path_factory.mktemp("ckpt")
    for sub in ("disk", "kv"):
        (out / sub).mkdir()
    server = KVStoreServer(("127.0.0.1", 0))
    server.start()
    try:
        env = {"HOROVOD_TPU_CHECKPOINT_INTERVAL_STEPS": "1"}
        disk = World("ckpt", 2, out / "disk", env=dict(
            env, HOROVOD_TPU_CHECKPOINT_DIR=str(out / "disk" / "ckpt"),
            CKPT_ZERO1_DIR=str(out / "disk" / "zero1")), timeout=60)
        kv = World("ckpt", 2, out / "kv", env=dict(
            env, HOROVOD_TPU_CHECKPOINT_DIR=str(out / "kv" / "ckpt"),
            HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
            HOROVOD_GLOO_RENDEZVOUS_PORT=str(server.port)), timeout=60)
        yield {"disk": (out / "disk", disk.results()),
               "kv": (out / "kv", kv.results(), server)}
    finally:
        server.stop()


def _restore_template():
    model, opt = ckpt_model_and_opt(hvd, "cpu")
    return training_template(model, opt)


def _check_restored(res, r0):
    got = ckpt_numpy(res.tree)
    want = r0["provided"][res.step]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    assert res.extras == {"batch": res.step}


def test_np2_world_snapshots_through_the_step_hook(ckpt_worlds):
    """Both ranks snapshot at every step through the engine hook; the
    np=2 generation passes the commit barrier and restores at np=1 to
    bitwise what rank 0's provider returned, also with rank1/ gone."""
    root, res = ckpt_worlds["disk"]
    for r in res:
        assert r["idle"] and r["interval"] == 1 and not r["kv"]
        assert r["last_written"] == CKPT_STEPS
        assert sorted(r["provided"]) == list(range(1, CKPT_STEPS + 1))
    # the ranks' replicas stay equal: averaged gradients
    for k, v in res[0]["provided"][CKPT_STEPS].items():
        assert v.tobytes() == res[1]["provided"][CKPT_STEPS][k].tobytes()
    ckpt = root / "ckpt"
    m = CheckpointManager(str(ckpt), rank=0, world_size=1)
    try:
        found = m.latest_generation()
        assert found is not None and found[0] == CKPT_STEPS
        ok, errs = generation_complete(found[1])
        assert ok, errs
        assert found[1][0]["world_size"] == 2
        _check_restored(m.restore_latest(template=_restore_template()),
                        res[0])
    finally:
        m.close(flush=False)
    shutil.rmtree(ckpt / "rank1")
    m = CheckpointManager(str(ckpt), rank=0, world_size=1)
    try:
        _check_restored(m.restore_latest(template=_restore_template()),
                        res[0])
    finally:
        m.close(flush=False)


def test_np2_world_restores_from_the_kv_alone(ckpt_worlds, tmp_path):
    """With the KV named at launch, the np=2 generation restores at np=1
    into a private directory after both rank directories are gone."""
    root, res, server = ckpt_worlds["kv"]
    assert all(r["kv"] and r["last_written"] == CKPT_STEPS for r in res)
    assert server.snapshot("ckptshard").get("ckptshard")
    shutil.rmtree(root / "ckpt" / "rank0")
    shutil.rmtree(root / "ckpt" / "rank1")
    m = CheckpointManager(str(tmp_path / "private"), rank=0, world_size=1,
                          kv=("127.0.0.1", server.port))
    try:
        res0 = m.restore_latest(template=_restore_template())
    finally:
        m.close(flush=False)
    assert res0.step == CKPT_STEPS
    _check_restored(res0, res[0])


def test_np2_zero1_generation_reshards_alike_in_both_packages(ckpt_worlds):
    """The np=2 world's ZeRO-1 generation (AdamW through
    checkpoint_payload()): both packages' zero1_reshard give equal arrays
    at new worlds of 1 and 3, whose full buckets are the parameters the
    world ended with."""
    root, res = ckpt_worlds["disk"]
    assert all(r["zero1_idle"] and r["zero1_written"] == CKPT_ZERO1_STEPS
               for r in res)
    gen = f"gen{CKPT_ZERO1_STEPS}"
    header = json.loads((root / "zero1" / "rank0" / gen /
                         "header.json").read_text())
    assert header["mode"] == "zero1" and header["world_size"] == 2
    assert [m["bucket"] for m in header["state_leaves"]] == \
        [None, 0, 1, 0, 1]
    payloads = {r: (root / "zero1" / f"rank{r}" / gen /
                    f"shard_{r}.bin").read_bytes() for r in range(2)}
    for r in range(2):
        z = res[r]["zero1"]
        assert payloads[r] == b"".join(a.tobytes() for a in
                                       z["shards"] + z["state"])
    # each bucket packs its parameters flat, in the optimizer's order
    full = [np.concatenate([res[0]["zero1"]["params"][i].ravel()
                            for i in b["idxs"]])
            for b in header["buckets"]]
    for new_n in (1, 3):
        for new_rank in range(new_n):
            got = zero1_reshard(header, payloads, new_rank, new_n)
            want = ref_shard_io.zero1_reshard(header, payloads, new_rank,
                                              new_n)
            for key in ("shards", "state_leaves", "full_buckets"):
                assert len(got[key]) == len(want[key])
                for a, b in zip(got[key], want[key]):
                    assert a.numpy().tobytes() == b.tobytes(), key
            for a, b in zip(got["full_buckets"], full):
                assert a.numpy().tobytes() == \
                    np.ascontiguousarray(b).tobytes()


def test_np2_zero1_generation_restores_at_np1_through_the_optimizer(
        ckpt_worlds, monkeypatch):
    """restore_from_durable of the np=2 ZeRO-1 generation into this
    process's size-1 sharded optimizer: the parameters are the world's,
    the moments both ranks' shards joined."""
    root, res = ckpt_worlds["disk"]
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        hvd.global_state().config.fusion_threshold_bytes = SHARDED_THRESHOLD
        m = CheckpointManager(str(root / "zero1"), rank=0, world_size=1)
        try:
            tree = m.restore_latest().tree
        finally:
            m.close(flush=False)
        model, opt = ckpt_model_and_opt(hvd, "cpu", sharded=True)
        opt.restore_from_durable(tree)
        for p, want in zip(model.parameters(), res[0]["zero1"]["params"]):
            assert p.detach().numpy().tobytes() == want.tobytes()
        shards, leaves, _ = opt.checkpoint_payload()
        totals = [b.total for b in opt._zero.buckets]
        assert int(leaves[0]) == CKPT_ZERO1_STEPS
        for j, leaf in enumerate(leaves[1:], start=1):
            b = (j - 1) % len(totals)
            joined = np.concatenate([r["zero1"]["state"][j]
                                     for r in res])[:totals[b]]
            assert leaf.numpy()[:totals[b]].tobytes() == joined.tobytes()
    finally:
        hvd.shutdown()
