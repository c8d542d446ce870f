"""The system under test, built from a configuration file: one
``VirtualCluster`` (``"kind": "cluster"``) or one ``TenantFleet`` of
``tenants`` clusters (``"kind": "fleet"``), with its settled state kept on
the device so that every request starts from it again.

This is the benchmark's only module that builds the program's objects; the
loops (:mod:`benchmark.loops`) drive them through the program's own entry
points.
"""

from __future__ import annotations

import torch

from benchmark import generator

#: Lanes read back as a request's answer (with a leading tenant axis).
ANSWER_LANES = ("alive", "join_pending", "config_epoch", "config_hi", "config_lo", "n_members")
RING_LANES = ("obs_idx", "subj_idx")


def _create(config: dict, seed: int, tenant: int, device):
    from rapid_tpu_torch.models.virtual_cluster import VirtualCluster

    vc = VirtualCluster.create(
        config["n_members"], n_slots=config["n_slots"], k=config["k"], h=config["h"],
        l=config["l"], cohorts=config["cohorts"], fd_threshold=config["fd_threshold"],
        seed=generator.cluster_seed(seed, tenant), fallback_rounds=config["fallback_rounds"],
        delivery_spread=config["delivery_spread"],
        delivery_prob_permille=config["delivery_prob_permille"],
        concurrent_coordinators=config["concurrent_coordinators"], device=device,
    )
    vc.assign_cohorts_roundrobin()
    vc.stagger_fd_counts(generator.rng(seed, 5, tenant), spread_rounds=config["fd_stagger_rounds"])
    return vc


def _clone(tree):
    return type(tree)(*(lane.clone() for lane in tree))


class Target:
    """The program's object (``self.system``) and its settled state."""

    def __init__(self, config: dict, seed: int, device: torch.device):
        from rapid_tpu_torch.tenancy import TenantFleet

        self.config, self.device = config, device
        self.fleet = config["kind"] == "fleet"
        if self.fleet:
            # Built on the host and moved: one upload per lane instead of
            # each tenant's small launches.
            host = TenantFleet.from_clusters(
                [_create(config, seed, t, torch.device("cpu")) for t in range(config["tenants"])]
            )
            moved = [type(tree)(*(lane.to(device) for lane in tree))
                     for tree in (host.state, host.faults, host.knobs)]
            self.system = TenantFleet(host.cfg, *moved)
        else:
            if config["tenants"] != 1:
                raise ValueError("a cluster configuration has one tenant")
            self.system = _create(config, seed, 0, device)
        self._settled = (_clone(self.system.state), _clone(self.system.faults))

    def restore(self) -> None:
        """Put the settled state back (device copies; nothing is read)."""
        state, faults = self._settled
        self.system.state, self.system.faults = _clone(state), _clone(faults)

    def answer(self, rings=RING_LANES) -> dict:
        """The committed view's lanes as device tensors with a tenant
        axis."""
        state = self.system.state
        lanes = {name: getattr(state, name) for name in ANSWER_LANES + tuple(rings)}
        if not self.fleet:
            lanes = {name: lane.unsqueeze(0) for name, lane in lanes.items()}
        return lanes


def host_answer(answer: dict) -> dict:
    """A request's answer as numpy arrays."""
    return {name: lane.cpu().numpy() for name, lane in answer.items()}

