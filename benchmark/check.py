"""The comparison that decides ``correct``.

Every request of a run (the window's and the traced stretch's) is judged,
tenant by tenant, against the plain reference (:mod:`benchmark.reference`),
once the window has closed. The reference starts from the inputs alone: the
seeded identities and ring keys (:func:`benchmark.generator.identities`), the
first ``n_members`` slots as the members, and the request's churn. The
program's answer is only read, to be judged.

The numbers compared, each a count of tenant answers, with its limit:

- ``unresolved``: a burst the program itself reports as not resolved, or an
  answer with a joiner still pending;
- ``members_wrong``: the committed members differ from the reference's (a
  crash left in, a joiner left out, a member removed that was not crashed),
  or the member count disagrees with them;
- ``config_id_wrong``: the configuration id differs from the reference's;
- ``rings_wrong``: on a sample of requests drawn from the seed, an
  observer or subject of any of the K rings differs from the reference's.

Each is an exact comparison, so each limit is 0.
"""

from __future__ import annotations

import numpy as np

from benchmark import generator
from benchmark.reference import membership

NUMBERS = ("unresolved", "members_wrong", "config_id_wrong", "rings_wrong")
LIMITS = {name: 0 for name in NUMBERS}


class Reference:
    """The reference's view of each tenant: identities and ring orders from
    the seed, computed once."""

    def __init__(self, config: dict, seed: int):
        n, slots, k = config["n_members"], config["n_slots"], config["k"]
        self.alive0 = np.arange(slots) < n
        self.ids, self.orders = [], []
        for t in range(config["tenants"]):
            key_hi, key_lo, id_hi, id_lo = generator.identities(generator.cluster_seed(seed, t), slots, k)
            self.ids.append((id_hi, id_lo))
            self.orders.append(membership.ring_orders(key_hi, key_lo))

    def view(self, tenant: int, churn: generator.Churn, rings: bool) -> dict:
        alive = membership.after_churn(self.alive0, churn.crash, churn.join)
        view = {"alive": alive, "config_id": membership.config_id(*self.ids[tenant], alive)}
        if rings:
            view["rings"] = membership.rings(self.orders[tenant], alive)
        return view


def u32(x) -> int:
    return int(x) & 0xFFFFFFFF


def judge_answer(reference: Reference, record: dict, answer: dict) -> dict:
    """The counts of one request's wrong tenant answers. ``answer`` holds
    the program's lanes as numpy arrays with a leading tenant axis."""
    counts = dict.fromkeys(NUMBERS, 0)
    rings = "obs_idx" in answer
    resolved = record["resolved"]
    for t, churn in enumerate(record["churn"]):
        want = reference.view(t, churn, rings)
        alive = np.asarray(answer["alive"][t], dtype=bool)
        if not resolved[t] or answer["join_pending"][t].any():
            counts["unresolved"] += 1
        if not np.array_equal(alive, want["alive"]) or int(answer["n_members"][t]) != int(want["alive"].sum()):
            counts["members_wrong"] += 1
        if (u32(answer["config_hi"][t]), u32(answer["config_lo"][t])) != want["config_id"]:
            counts["config_id_wrong"] += 1
        if rings:
            observer, subject = want["rings"]
            if not (np.array_equal(answer["obs_idx"][t], observer)
                    and np.array_equal(answer["subj_idx"][t], subject)):
                counts["rings_wrong"] += 1
    return counts


def judge(reference: Reference, records, answers) -> tuple:
    """``(attempted, failed, numbers)`` over the requests: a request fails
    when any of its tenant answers is wrong; ``numbers`` maps each name to
    ``(count, limit)``."""
    totals = dict.fromkeys(NUMBERS, 0)
    failed = 0
    for record, answer in zip(records, answers):
        counts = judge_answer(reference, record, answer)
        failed += any(counts.values())
        for name, value in counts.items():
            totals[name] += value
    return len(records), failed, {name: (totals[name], LIMITS[name]) for name in NUMBERS}
