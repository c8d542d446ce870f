"""Framework configuration (a copy of ``rapid_tpu/settings.py``).

Mirrors the reference's ``Settings`` knob set (``Settings.java:21-112``) and
fixes its one structural gap: the protocol constants K/H/L were hardcoded in
``Cluster.java:72-74``; here they are first-class configuration. The port
reads it for the chaos subsystem's watermarks and simulation profiles
(:mod:`rapid_tpu_torch.sim`); the host protocol it configures is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

#: The ring-topology modes (a copy of ``rapid_tpu/protocol/view.py``'s
#: ``TOPOLOGIES``). The engine takes only the native one
#: (``ops/rings.endpoint_ring_keys``).
TOPOLOGIES = ("native", "java")


@dataclass
class Settings:
    # Protocol constants (reference defaults: Cluster.java:72-74).
    k: int = 10
    h: int = 9
    l: int = 4

    # Messaging (GrpcClient.java:55-59).
    rpc_timeout_ms: int = 1000
    rpc_default_retries: int = 5
    rpc_join_timeout_ms: int = 5000
    rpc_probe_timeout_ms: int = 1000

    # Protocol timing (MembershipService.java:75-78, FastPaxos.java:46).
    failure_detector_interval_ms: int = 1000
    batching_window_ms: int = 100
    consensus_fallback_base_delay_ms: int = 1000

    # Join client (Cluster.java:71).
    join_attempts: int = 5

    # Leave (MembershipService.java:78).
    leave_message_timeout_ms: int = 1500

    # Protocol-level delivery liveness. The reference guarantees message
    # delivery inside the transport (bounded retries, Retries.java:43-90;
    # channel retry wrapper GrpcClient.java:106-115), so its protocol can
    # fire every broadcast exactly once. Transports here may be lossy (the
    # UDP hybrid ships one-way traffic as droppable datagrams), so the
    # equivalent guarantee lives at the protocol level instead:
    # - alert batches for the current configuration are re-broadcast on this
    #   cadence while the cut they announce is still unresolved (0 = off);
    # - a node that suspects it is stale (undecided proposal, unresolved cut,
    #   or traffic stamped with a configuration id it does not know) pulls
    #   the current configuration from a peer over the reliable path on this
    #   cadence (0 = off).
    alert_redelivery_interval_ms: int = 1000
    config_sync_interval_ms: int = 2000
    # Anti-entropy heartbeat: even with NO local suspicion a member pulls a
    # peer's configuration this often (0 = off). This is the only mechanism
    # that reaches a member which missed a decision AND has no local
    # evidence of it AND receives no traffic at all afterwards (e.g. its
    # ingress was partitioned through the decision and the cluster went
    # quiescent) — suspicion-based sync and evidence pulls both need some
    # signal; this needs none. Deliberately slow, and cheap when current:
    # the pull carries the requester's configuration id, so an up-to-date
    # peer answers with a compact "unchanged" response instead of streaming
    # the full O(N) configuration (protocol/service.py::_catch_up; native
    # topology only — java-topology clusters keep the joiner's -1 sentinel
    # because a reference JVM peer has no unchanged fast path).
    config_sync_idle_interval_ms: int = 30_000

    # Two-level hierarchical membership (rapid_tpu/hier; ROADMAP item 3).
    # 0 = flat Rapid (every alert/vote fans out cluster-wide). > 0 = cohort
    # mode: the membership is deterministically partitioned into cohorts of
    # roughly this size (seeded by hier_seed, rebalanced only at
    # reconfiguration); failure detection, alert broadcast, and the fast
    # consensus round are scoped to the cohort, and a small delegate
    # committee serializes cohort cut proposals into the single cluster-wide
    # configuration chain. Cluster-wide knob: every member must agree on
    # both values or nodes compute different cohort maps and the fast path
    # degrades to anti-entropy catch-up.
    hier_target_cohort_size: int = 0
    hier_seed: int = 0

    # Topology mode: "native" (tpu-first default: 8-byte port hashing,
    # unsigned key/identifier ordering) or "java" (reference-exact ring
    # ordering and configuration-id fold, MembershipView.java:544-587 —
    # required for mixed clusters with the Java implementation over the
    # interop transport). Cluster-wide: every member must use the same mode
    # or configuration ids diverge immediately.
    topology: str = "native"

    def validate(self) -> None:
        if not (self.k >= 3 and self.k >= self.h >= self.l >= 1):
            raise ValueError(
                f"K/H/L must satisfy K>=3 and K>=H>=L>=1, got K={self.k} H={self.h} L={self.l}"
            )
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"topology must be one of {TOPOLOGIES}, got {self.topology!r}"
            )
        if self.hier_target_cohort_size < 0 or self.hier_target_cohort_size == 1:
            # A 1-member cohort could never detect its own failure; 0 means
            # flat mode, >= 2 is a real hierarchy.
            raise ValueError(
                "hier_target_cohort_size must be 0 (flat) or >= 2, got "
                f"{self.hier_target_cohort_size}"
            )
