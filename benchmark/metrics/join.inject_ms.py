"""join.inject_ms: host time of a join wave's injection, in ms, unprofiled: the
median over the program's inject_join_wave dispatch records
(rapid_tpu_torch.utils.dispatch.records) of (wall - counted-read time),
profiled dispatches left out. The gatekeepers' search over the K rings and
the joiners' lanes are in it; the wait in the admissibility read is not. None
where the program keeps no such record."""

import statistics


def read(run):
    try:
        from rapid_tpu_torch.utils.dispatch import records
    except ImportError:
        return None
    waves = [(r.wall_ns - r.read_ns) / 1e6 for r in records()
             if r.entry == "inject_join_wave" and not r.profiled]
    return statistics.median(waves) if waves else None
