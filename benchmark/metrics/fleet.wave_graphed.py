"""fleet.wave_graphed: the share of the program's unprofiled fleet_wave
dispatch records (rapid_tpu_torch.utils.dispatch.records) that replayed a
captured CUDA graph, in %. None where the program keeps no such record or
records no such flag."""


def read(run):
    try:
        from rapid_tpu_torch.utils.dispatch import records
    except ImportError:
        return None
    waves = [r for r in records() if r.entry == "fleet_wave" and not r.profiled]
    flags = [getattr(r, "graphed", None) for r in waves]
    if not flags or None in flags:
        return None
    return 100.0 * sum(flags) / len(flags)
