"""serve_frames_per_s: mel frames returned to callers within the window,
over the window's seconds."""


def read(rec):
    return rec["frames_in_window"] / rec["window_s"]
