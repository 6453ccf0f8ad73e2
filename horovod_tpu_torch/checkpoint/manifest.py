"""Per-rank shard manifests + the generation commit barrier.

Every rank publishes one manifest per generation — to its own disk
(``manifest_<rank>.json`` in the generation directory) and, when a
rendezvous KV is configured, under ``ckpt/<rank>`` (the
``stall/<rank>`` / ``metrics/<rank>`` pattern). A generation is
**complete** only when every writer rank's manifest is present and all
of them agree on ``(step, world_version, world_size, layout_digest)``
and on the per-shard checksums — the commit barrier that keeps a
half-written generation from ever being restored. Partial generations
are garbage-collected by the manager.

The port's copy of ``horovod_tpu/checkpoint/manifest.py``: the same
schema, checksums and barriers, so the two packages read each other's
manifests.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

MANIFEST_VERSION = 1

# every manifest must carry these keys with these types
_SCHEMA: Dict[str, type] = {
    "version": int,
    "rank": int,
    "step": int,
    "world_version": int,
    "world_size": int,
    "layout_digest": str,
    "shard_checksums": dict,   # {str(shard_rank): sha256 hex}
    "shard_bytes": dict,       # {str(shard_rank): int}
    "holds": list,             # shard ranks physically held by this rank
}


def checksum(data: bytes) -> str:
    """The shard integrity checksum (sha256 hex)."""
    return hashlib.sha256(data).hexdigest()


def build_manifest(rank: int, *, step: int, world_version: int,
                   world_size: int, layout_digest: str,
                   shard_checksums: Dict[int, str],
                   shard_bytes: Dict[int, int],
                   holds: List[int]) -> dict:
    """One rank's manifest: generation identity plus the checksums/sizes
    of every shard this rank physically holds (its own + peer
    replicas)."""
    return {
        "version": MANIFEST_VERSION,
        "rank": int(rank),
        "step": int(step),
        "world_version": int(world_version),
        "world_size": int(world_size),
        "layout_digest": str(layout_digest),
        "shard_checksums": {str(k): str(v)
                            for k, v in shard_checksums.items()},
        "shard_bytes": {str(k): int(v) for k, v in shard_bytes.items()},
        "holds": sorted(int(h) for h in holds),
    }


def validate_manifest(m: dict) -> List[str]:
    """Schema errors for one manifest (empty = valid)."""
    errors: List[str] = []
    if not isinstance(m, dict):
        return [f"manifest is {type(m).__name__}, expected dict"]
    for key, typ in _SCHEMA.items():
        if key not in m:
            errors.append(f"manifest missing required key {key!r}")
        elif not isinstance(m[key], typ) or isinstance(m[key], bool):
            errors.append(f"manifest key {key!r} is "
                          f"{type(m[key]).__name__}, expected "
                          f"{typ.__name__}")
    if errors:
        return errors
    if m["version"] != MANIFEST_VERSION:
        errors.append(f"manifest version {m['version']} != "
                      f"{MANIFEST_VERSION}")
    if not (0 <= m["rank"] < m["world_size"]):
        errors.append(f"manifest rank {m['rank']} outside world "
                      f"[0, {m['world_size']})")
    if str(m["rank"]) not in m["shard_checksums"]:
        errors.append(f"manifest for rank {m['rank']} does not checksum "
                      f"its own shard")
    for k, v in m["shard_checksums"].items():
        if not (isinstance(v, str) and len(v) == 64):
            errors.append(f"shard_checksums[{k}] is not a sha256 hex "
                          f"digest: {v!r}")
    for h in m["holds"]:
        if str(h) not in m["shard_checksums"]:
            errors.append(f"held shard {h} has no checksum entry")
    return errors


def generation_restorable(manifests: Dict[int, dict]
                          ) -> Tuple[bool, List[str]]:
    """The restore-side barrier: a lost host takes its manifest copy
    with it, so restore accepts a generation when the *surviving*
    manifests agree on ``(step, world_version, world_size,
    layout_digest)`` AND every writer shard ``0..N-1`` is physically
    held (own or replica) by some surviving rank. A generation a rank
    never committed cannot pass: nobody replicates a shard before its
    owner published it, so the coverage check fails exactly when the
    commit barrier would have."""
    ok, errors = _agree(manifests)
    if not ok:
        return False, errors
    ref = manifests[min(manifests)]
    held = set()
    for m in manifests.values():
        held.update(int(h) for h in m["holds"])
    uncovered = [q for q in range(ref["world_size"]) if q not in held]
    if uncovered:
        errors.append(
            f"shards {uncovered} are held by no surviving rank "
            f"(redundancy exceeded, or the generation never committed)")
    return not errors, errors


def _agree(manifests: Dict[int, dict]) -> Tuple[bool, List[str]]:
    """Shared agreement core: every present manifest is schema-valid and
    they all agree on ``(step, world_version, world_size,
    layout_digest)`` and on every shard's checksum."""
    errors: List[str] = []
    if not manifests:
        return False, ["no manifests"]
    for r, m in manifests.items():
        errs = validate_manifest(m)
        if errs:
            errors += [f"rank {r}: {e}" for e in errs]
    if errors:
        return False, errors
    ref = manifests[min(manifests)]
    for r, m in sorted(manifests.items()):
        if m["rank"] != r:
            errors.append(f"manifest under rank {r} claims rank "
                          f"{m['rank']}")
        for key in ("step", "world_size", "layout_digest"):
            if m[key] != ref[key]:
                errors.append(f"rank {r} disagrees on {key}: "
                              f"{m[key]!r} != {ref[key]!r}")
        if m["world_version"] != ref["world_version"]:
            errors.append(
                f"stale world_version: rank {r} wrote world_version "
                f"{m['world_version']} but rank {ref['rank']} wrote "
                f"{ref['world_version']} — the generation spans an "
                f"elastic reset and must not be restored")
    # cross-rank checksum agreement: a replica whose checksum differs
    # from the owner's copy is corrupt (or from another generation)
    by_shard: Dict[str, str] = {}
    for r, m in sorted(manifests.items()):
        for q, c in m["shard_checksums"].items():
            if q in by_shard and by_shard[q] != c:
                errors.append(f"checksum mismatch for shard {q}: rank "
                              f"{r} holds {c[:12]}…, another rank holds "
                              f"{by_shard[q][:12]}…")
            by_shard.setdefault(q, c)
    return not errors, errors


def generation_complete(manifests: Dict[int, dict]
                        ) -> Tuple[bool, List[str]]:
    """The commit barrier proper: valid only when **every** writer
    rank's manifest is present and :func:`_agree` holds. A
    stale-world_version or checksum-mismatched manifest set is rejected
    with a named error; so is a partial generation (a rank that never
    committed)."""
    ok, errors = _agree(manifests)
    if not ok:
        return False, errors
    ref = manifests[min(manifests)]
    missing = [r for r in range(ref["world_size"]) if r not in manifests]
    if missing:
        errors.append(f"incomplete generation: missing manifests from "
                      f"ranks {missing} (have {sorted(manifests)})")
    return not errors, errors
