"""loader.wait_share: seconds the training loop spent in ``next()`` on the
prefetch iterator over the seconds of those steps, in percent (steps run
before the profiler started)."""


def read(rec):
    return 100.0 * rec["loader_wait_s"] / rec["clean_s"] if rec.get("clean_s") else None
