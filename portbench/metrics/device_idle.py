"""device_idle: share of the profiled stretch in which no operation ran on
the device (1 - busy / stretch), in percent."""


def read(rec):
    prof = rec.get("profile")
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"]) if prof else None
