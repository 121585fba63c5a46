"""device_idle_pct (%): 100 less the share of the profiled stretch (spans
off) in which a device operation ran: the union of the profiler's device
intervals over the stretch's wall."""


def read(run):
    p = run.profile
    if not p or not p["window_s"] or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
