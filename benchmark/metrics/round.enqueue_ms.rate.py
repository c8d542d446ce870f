"""round.enqueue_ms.rate: host time issuing a round, in ms, unprofiled: the
median over the program's records of its fleet_wave dispatches
(rapid_tpu_torch.utils.dispatch.records) of (wall - counted-read time) /
rounds (the wave's lockstep rounds), profiled dispatches left out. The
view changes and the lockstep select are in it; the wait in the wave's one
packed read is not. None where the program keeps no such record."""

import statistics


def read(run):
    try:
        from rapid_tpu_torch.utils.dispatch import records
    except ImportError:
        return None
    per_round = [(r.wall_ns - r.read_ns) / r.rounds / 1e6 for r in records()
                 if r.entry == "fleet_wave" and not r.profiled and r.rounds]
    return statistics.median(per_round) if per_round else None
