"""Consistent-hash shard ring, shared by the downward and upward syncer
fleets (and any future tenant-partitioned controller).

Each shard contributes ``vnodes`` deterministic points on a sha256 ring; a
tenant maps to the first point clockwise of its own hash. Same UID + same
shard count -> same shard across restarts, and growing the fleet from N to
N+1 shards remaps only ~1/(N+1) of the tenants (the slices the new shard's
vnodes claim) instead of ~all, which is what makes live fleet resizing a
cheap operation.
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Dict, List, Tuple


class ShardRing:
    """Consistent-hash ring mapping tenant UIDs to shards."""

    def __init__(self, num_shards: int, vnodes: int = 64) -> None:
        self.num_shards = max(1, int(num_shards))
        self.vnodes = max(1, int(vnodes))
        points: List[Tuple[int, int]] = []
        for s in range(self.num_shards):
            for v in range(self.vnodes):
                h = int(hashlib.sha256(
                    f"shard-{s}/vn-{v}".encode()).hexdigest(), 16)
                points.append((h, s))
        points.sort()
        self._hashes = [p[0] for p in points]
        self._shards = [p[1] for p in points]

    def shard_for(self, tenant_uid: str) -> int:
        if self.num_shards == 1:
            return 0
        h = int(hashlib.sha256(tenant_uid.encode()).hexdigest(), 16)
        i = bisect.bisect_right(self._hashes, h) % len(self._hashes)
        return self._shards[i]


_ring_cache: Dict[Tuple[int, int], ShardRing] = {}
_ring_cache_lock = threading.Lock()


def shard_for(tenant_uid: str, num_shards: int, vnodes: int = 64) -> int:
    """Stable tenant->shard partition: same UID always lands on one shard.

    Consistent-hash ring (not modulo), so N -> N+1 remaps ~1/N tenants.
    """
    if num_shards <= 1:
        return 0
    key = (num_shards, vnodes)
    with _ring_cache_lock:
        ring = _ring_cache.get(key)
        if ring is None:
            ring = _ring_cache[key] = ShardRing(num_shards, vnodes)
    return ring.shard_for(tenant_uid)
