"""round.enqueue_ms.latency: host time issuing a round, in ms, unprofiled: the
median over the program's records of its run_until_membership dispatches
(rapid_tpu_torch.utils.dispatch.records) of (wall - counted-read time) /
rounds, profiled dispatches left out. The view change and the loop's
bookkeeping are in it; the waits in the loop's counted reads are not. None where
the program keeps no such record."""

import statistics


def read(run):
    try:
        from rapid_tpu_torch.utils.dispatch import records
    except ImportError:
        return None
    per_round = [(r.wall_ns - r.read_ns) / r.rounds / 1e6 for r in records()
                 if r.entry == "run_until_membership" and not r.profiled and r.rounds]
    return statistics.median(per_round) if per_round else None
