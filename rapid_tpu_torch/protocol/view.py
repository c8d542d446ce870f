"""K-ring expander membership view.

Semantics follow the reference's ``MembershipView``
(``rapid/src/main/java/com/vrg/rapid/MembershipView.java``): K pseudo-random
permutations of the member list, each ordered by a seeded 64-bit hash of the
endpoint; a node's *observers* are its K successors, its *subjects* its K
predecessors (``MembershipView.java:234-322``); a 64-bit configuration id is
folded from the identifiers and ring-0 member order
(``MembershipView.java:544-556``).

Representation is TPU-minded rather than object-per-ring: each ring is a flat
sorted array of ``(key, endpoint)`` maintained by bisection. ``ring_keys()``
exposes the raw per-ring hash keys so the device kernels in
``rapid_tpu_torch.ops.rings`` can operate on exactly the same ordering.

A copy of ``rapid_tpu/protocol/view.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Set, Tuple

from rapid_tpu_torch.errors import (
    NodeAlreadyInRingError,
    NodeNotInRingError,
    UUIDAlreadySeenError,
)
from rapid_tpu_torch.types import Endpoint, JoinStatusCode, NodeId
from rapid_tpu_torch.utils.xxhash import to_signed64, xxh64, xxh64_int, xxh64_int4

_MASK64 = (1 << 64) - 1

#: Topology modes. NATIVE is the tpu-first default: ports hashed as 8 bytes,
#: keys and identifiers ordered unsigned — one uniform u64 keyspace shared
#: with the device kernels (rapid_tpu_torch.ops.rings ships u32 hi/lo words).
#: JAVA_COMPAT reproduces the reference's exact semantics — ports hashed as
#: 4-byte Java ints (``LongHashFunction.hashInt``), ring keys compared as
#: SIGNED longs (``Long.compare``, MembershipView.java:573-577), identifiers
#: ordered by the signed (high, low) NodeIdComparator
#: (MembershipView.java:474-499) — so a compat-mode cluster computes the same
#: ring orders, observer/subject sets, and configuration ids a Java cluster
#: would, making mixed clusters over the interop transport possible in
#: principle.
TOPOLOGY_NATIVE = "native"
TOPOLOGY_JAVA = "java"
TOPOLOGIES = (TOPOLOGY_NATIVE, TOPOLOGY_JAVA)


def ring_key(endpoint: Endpoint, seed: int) -> int:
    """The seeded ordering key for one ring, native mode (semantics of
    ``MembershipView.AddressComparator``, MembershipView.java:562-587, with
    the port hashed as 8 bytes and the key compared unsigned)."""
    h = xxh64(endpoint.hostname.encode("utf-8"), seed)
    return (h * 31 + xxh64_int(endpoint.port, seed)) & _MASK64


def ring_key_java(endpoint: Endpoint, seed: int) -> int:
    """Reference-exact ring key, returned SIGNED so Python's natural int
    ordering reproduces Java's ``Long.compare``: ``xx(seed).hashBytes(
    hostname_utf8) * 31 + xx(seed).hashInt(port)`` in wrapping 64-bit
    arithmetic (MembershipView.java:579-587)."""
    h = xxh64(endpoint.hostname.encode("utf-8"), seed)
    return to_signed64((h * 31 + xxh64_int4(endpoint.port, seed)) & _MASK64)


def _ring_key_for(topology: str):
    return ring_key_java if topology == TOPOLOGY_JAVA else ring_key


def node_id_sort_key(node_id: NodeId, topology: str = TOPOLOGY_NATIVE):
    """Identifier ordering for the configuration fold: unsigned (high, low)
    natively; Java's signed NodeIdComparator (MembershipView.java:474-499)
    in compat mode."""
    if topology == TOPOLOGY_JAVA:
        return (to_signed64(node_id.high), to_signed64(node_id.low))
    return (node_id.high, node_id.low)


def configuration_id_of(
    node_ids: Sequence[NodeId],
    endpoints: Sequence[Endpoint],
    topology: str = TOPOLOGY_NATIVE,
) -> int:
    """Deterministic 64-bit fold over identifiers-seen and membership
    (semantics of ``MembershipView.Configuration.getConfigurationId``,
    MembershipView.java:544-556). ``node_ids`` must be in the topology's
    sorted order and ``endpoints`` in the topology's ring-0 order for all
    members to agree. In JAVA mode the fold is reference-exact (seed-0 xxHash,
    ports as 4-byte ints), so a compat cluster computes the ids a Java
    cluster would.

    Returned as *signed* 64-bit (Java-long convention, and the wire codec's
    i64): every host-path config-id comparison uses this signed canonical
    form. (The device engine's config identity is a separate unsigned
    set-hash space, never compared against this fold.)"""
    if topology != TOPOLOGY_JAVA:
        from rapid_tpu_torch.utils._native import native_configuration_id

        native = native_configuration_id(
            [nid.high for nid in node_ids],
            [nid.low for nid in node_ids],
            [ep.hostname.encode("utf-8") for ep in endpoints],
            [ep.port for ep in endpoints],
        )
        if native is not None:
            return to_signed64(native)
    hash_port = xxh64_int4 if topology == TOPOLOGY_JAVA else xxh64_int
    h = 1
    for nid in node_ids:
        h = (h * 37 + xxh64_int(nid.high)) & _MASK64
        h = (h * 37 + xxh64_int(nid.low)) & _MASK64
    for ep in endpoints:
        h = (h * 37 + xxh64(ep.hostname.encode("utf-8"))) & _MASK64
        h = (h * 37 + hash_port(ep.port)) & _MASK64
    return to_signed64(h)


class Configuration:
    """The serializable membership snapshot: (identifiers-seen, ring-0 member
    list). Sufficient to reconstruct an identical view — this is also the
    checkpoint format (MembershipView.java:521-533)."""

    __slots__ = ("node_ids", "endpoints", "topology", "_config_id")

    def __init__(
        self,
        node_ids: Sequence[NodeId],
        endpoints: Sequence[Endpoint],
        topology: str = TOPOLOGY_NATIVE,
    ):
        self.node_ids: Tuple[NodeId, ...] = tuple(node_ids)
        self.endpoints: Tuple[Endpoint, ...] = tuple(endpoints)
        self.topology = topology
        self._config_id: Optional[int] = None

    @property
    def configuration_id(self) -> int:
        if self._config_id is None:
            self._config_id = configuration_id_of(
                self.node_ids, self.endpoints, self.topology
            )
        return self._config_id


class MembershipView:
    """K sorted rings + identifier history. Single-owner (the protocol engine
    serializes all access, like the reference's single protocol executor)."""

    def __init__(
        self,
        k: int,
        node_ids: Sequence[NodeId] = (),
        endpoints: Sequence[Endpoint] = (),
        topology: str = TOPOLOGY_NATIVE,
    ) -> None:
        if k <= 0:
            raise ValueError("K must be > 0")
        if topology not in TOPOLOGIES:
            raise ValueError(f"topology must be one of {TOPOLOGIES}, got {topology!r}")
        self.k = k
        self.topology = topology
        self._ring_key = _ring_key_for(topology)
        # Per ring: parallel sorted lists of keys and endpoints.
        self._ring_keys: List[List[int]] = [[] for _ in range(k)]
        self._rings: List[List[Endpoint]] = [[] for _ in range(k)]
        self._key_cache: Dict[Endpoint, Tuple[int, ...]] = {}
        self._all_nodes: Set[Endpoint] = set()
        self._identifiers_seen: Set[NodeId] = set()
        self._config_dirty = True
        self._cached_configuration: Optional[Configuration] = None

        if endpoints:
            self._bulk_insert(list(endpoints))
        self._identifiers_seen.update(node_ids)

    # -- internal ---------------------------------------------------------

    def _bulk_insert(self, endpoints: List[Endpoint]) -> None:
        """Construct all K rings in one pass: batch-hash every key (native
        xxh64 when the C library is built — bit-identical to the Python
        path — else the per-endpoint fallback) and sort each ring once.
        O(K·N log N) against the incremental path's O(K·N²) list churn,
        with ~100× less hashing overhead via the native batch. Matters
        wherever a whole view is (re)built: join responses, checkpoint
        resume, and config catch-up installs, which run inside the protocol
        lock. Tie-break matches ``_insert`` exactly: equal keys order by
        endpoint."""
        if self._all_nodes:
            # Bulk construction is a from-empty operation: overwriting rings
            # on a populated view would strand existing members in
            # _all_nodes but absent from every ring.
            raise ValueError("_bulk_insert requires an empty view")
        keys_kn = None
        if self.topology == TOPOLOGY_NATIVE:
            from rapid_tpu_torch.utils._native import native_ring_keys_batch

            keys_kn = native_ring_keys_batch(
                [ep.hostname.encode("utf-8") for ep in endpoints],
                [ep.port for ep in endpoints],
                self.k,
            )
        if keys_kn is not None:
            # One vectorized conversion, not K·N numpy scalar extractions.
            key_rows = keys_kn.T.tolist()  # [n][k] python ints
            for ep, row in zip(endpoints, key_rows):
                self._key_cache[ep] = tuple(row)
        else:
            for ep in endpoints:
                self._key_cache[ep] = tuple(
                    self._ring_key(ep, seed) for seed in range(self.k)
                )
        for ring_idx in range(self.k):
            order = sorted(
                endpoints, key=lambda e: (self._key_cache[e][ring_idx], e)
            )
            self._rings[ring_idx] = order
            self._ring_keys[ring_idx] = [self._key_cache[e][ring_idx] for e in order]
        self._all_nodes.update(endpoints)

    def _keys_of(self, endpoint: Endpoint) -> Tuple[int, ...]:
        keys = self._key_cache.get(endpoint)
        if keys is None:
            keys = tuple(self._ring_key(endpoint, seed) for seed in range(self.k))
            self._key_cache[endpoint] = keys
        return keys

    def _insert(self, endpoint: Endpoint) -> None:
        keys = self._keys_of(endpoint)
        for ring_idx in range(self.k):
            pos = bisect.bisect_left(self._ring_keys[ring_idx], keys[ring_idx])
            # Break 64-bit key ties deterministically by endpoint ordering.
            while (
                pos < len(self._ring_keys[ring_idx])
                and self._ring_keys[ring_idx][pos] == keys[ring_idx]
                and self._rings[ring_idx][pos] < endpoint
            ):
                pos += 1
            self._ring_keys[ring_idx].insert(pos, keys[ring_idx])
            self._rings[ring_idx].insert(pos, endpoint)
        self._all_nodes.add(endpoint)

    def _position(self, ring_idx: int, endpoint: Endpoint) -> int:
        key = self._keys_of(endpoint)[ring_idx]
        pos = bisect.bisect_left(self._ring_keys[ring_idx], key)
        while pos < len(self._rings[ring_idx]) and self._rings[ring_idx][pos] != endpoint:
            pos += 1
        if pos >= len(self._rings[ring_idx]):
            raise NodeNotInRingError(str(endpoint))
        return pos

    # -- queries ----------------------------------------------------------

    def is_safe_to_join(self, node: Endpoint, node_id: NodeId) -> JoinStatusCode:
        """MembershipView.java:100-115."""
        if node in self._all_nodes:
            return JoinStatusCode.HOSTNAME_ALREADY_IN_RING
        if node_id in self._identifiers_seen:
            return JoinStatusCode.UUID_ALREADY_IN_RING
        return JoinStatusCode.SAFE_TO_JOIN

    def is_host_present(self, node: Endpoint) -> bool:
        return node in self._all_nodes

    def is_identifier_present(self, node_id: NodeId) -> bool:
        return node_id in self._identifiers_seen

    def identifiers_seen(self) -> frozenset:
        """The append-only identifier history. ``ring_delete`` never removes
        identifiers (MembershipView.java:167-201 semantics), so along the
        decided configuration chain this set only grows — which makes two
        configurations comparable without a version counter: the newer one
        has a strict superset of identifiers, or an equal identifier set and
        a strict subset of endpoints (equal-identifier chains are
        remove-only). The config catch-up path relies on this ordering."""
        return frozenset(self._identifiers_seen)

    @property
    def membership_size(self) -> int:
        return len(self._all_nodes)

    def ring(self, ring_idx: int) -> List[Endpoint]:
        return list(self._rings[ring_idx])

    def ring_keys(self, ring_idx: int) -> List[int]:
        """Raw sorted hash keys of one ring. In ``TOPOLOGY_NATIVE`` these are
        u64 values interchangeable with the device kernels
        (``ops.rings.endpoint_ring_keys`` computes the identical function).
        In ``TOPOLOGY_JAVA`` they are SIGNED 64-bit values in signed ring
        order — reference-compatible, but NOT device interchange: the engine
        path is native-topology only (``endpoint_ring_keys`` enforces it)."""
        return list(self._ring_keys[ring_idx])

    def observers_of(self, node: Endpoint) -> List[Endpoint]:
        """K ring-successors (MembershipView.java:234-257)."""
        if node not in self._all_nodes:
            raise NodeNotInRingError(str(node))
        if len(self._all_nodes) <= 1:
            return []
        out = []
        for ring_idx in range(self.k):
            pos = self._position(ring_idx, node)
            out.append(self._rings[ring_idx][(pos + 1) % len(self._rings[ring_idx])])
        return out

    def subjects_of(self, node: Endpoint) -> List[Endpoint]:
        """K ring-predecessors (MembershipView.java:267-282)."""
        if node not in self._all_nodes:
            raise NodeNotInRingError(str(node))
        if len(self._all_nodes) <= 1:
            return []
        return self._predecessors_of(node)

    def expected_observers_of(self, node: Endpoint) -> List[Endpoint]:
        """Gatekeepers of a joiner not yet in the ring: the nodes that would
        precede it on each ring (MembershipView.java:292-303)."""
        if not self._all_nodes:
            return []
        return self._predecessors_of(node)

    def _predecessors_of(self, node: Endpoint) -> List[Endpoint]:
        out = []
        keys = self._keys_of(node)
        for ring_idx in range(self.k):
            ring = self._rings[ring_idx]
            if node in self._all_nodes:
                pos = self._position(ring_idx, node)
            else:
                pos = bisect.bisect_left(self._ring_keys[ring_idx], keys[ring_idx])
            out.append(ring[(pos - 1) % len(ring)])
        return out

    def ring_numbers(self, observer: Endpoint, subject: Endpoint) -> List[int]:
        """All k such that ``observer`` monitors ``subject`` on ring k
        (MembershipView.java:397-418)."""
        subjects = self.subjects_of(observer)
        return [idx for idx, node in enumerate(subjects) if node == subject]

    # -- mutation ---------------------------------------------------------

    def ring_add(self, node: Endpoint, node_id: NodeId) -> None:
        """MembershipView.java:123-160."""
        if node_id in self._identifiers_seen:
            raise UUIDAlreadySeenError(f"{node} with identifier {node_id}")
        if node in self._all_nodes:
            raise NodeAlreadyInRingError(str(node))
        self._insert(node)
        self._identifiers_seen.add(node_id)
        self._config_dirty = True

    def ring_delete(self, node: Endpoint) -> None:
        """MembershipView.java:167-201."""
        if node not in self._all_nodes:
            raise NodeNotInRingError(str(node))
        for ring_idx in range(self.k):
            pos = self._position(ring_idx, node)
            del self._ring_keys[ring_idx][pos]
            del self._rings[ring_idx][pos]
        self._all_nodes.remove(node)
        self._key_cache.pop(node, None)
        self._config_dirty = True

    # -- configuration ----------------------------------------------------

    @property
    def configuration(self) -> Configuration:
        if self._config_dirty or self._cached_configuration is None:
            self._cached_configuration = Configuration(
                sorted(
                    self._identifiers_seen,
                    key=lambda nid: node_id_sort_key(nid, self.topology),
                ),
                self._rings[0],
                topology=self.topology,
            )
            self._config_dirty = False
        return self._cached_configuration

    @property
    def configuration_id(self) -> int:
        return self.configuration.configuration_id

    def ring_zero_sorted(self, endpoints) -> List[Endpoint]:
        """Canonical proposal order: ring-0 comparator
        (MembershipService.java:346-348)."""
        return sorted(endpoints, key=lambda ep: (self._ring_key(ep, 0), ep))
