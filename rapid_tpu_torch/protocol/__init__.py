"""The flat host membership path (copies of ``rapid_tpu/protocol``):
``Cluster`` over ``MembershipService``, the view, the cut detector and
Fast Paxos, with the two device adapters, ``DeviceCutDetector`` and
``DeviceVoteTally``, that run the cut tally and the vote tally as torch ops
on CUDA unless given ``device=``."""

from rapid_tpu_torch.protocol.cluster import Cluster
from rapid_tpu_torch.protocol.cut_detector import MultiNodeCutDetector
from rapid_tpu_torch.protocol.device_cut_detector import DeviceCutDetector
from rapid_tpu_torch.protocol.device_vote_tally import DeviceVoteTally
from rapid_tpu_torch.protocol.events import ClusterEvents, ClusterStatusChange, NodeStatusChange
from rapid_tpu_torch.protocol.fast_paxos import FastPaxos, fast_paxos_quorum
from rapid_tpu_torch.protocol.metadata import MetadataManager
from rapid_tpu_torch.protocol.service import MembershipService
from rapid_tpu_torch.protocol.paxos import Paxos, select_proposal_using_coordinator_rule
from rapid_tpu_torch.protocol.view import (
    TOPOLOGY_JAVA,
    TOPOLOGY_NATIVE,
    Configuration,
    MembershipView,
    configuration_id_of,
    ring_key,
    ring_key_java,
)

__all__ = [
    "Cluster",
    "MultiNodeCutDetector",
    "DeviceCutDetector",
    "DeviceVoteTally",
    "MembershipService",
    "ClusterEvents",
    "ClusterStatusChange",
    "NodeStatusChange",
    "FastPaxos",
    "fast_paxos_quorum",
    "MetadataManager",
    "Paxos",
    "select_proposal_using_coordinator_rule",
    "Configuration",
    "MembershipView",
    "configuration_id_of",
    "ring_key",
    "ring_key_java",
    "TOPOLOGY_JAVA",
    "TOPOLOGY_NATIVE",
]
