"""train_audio_s_per_s: real (unpadded) mel frames of the optimizer steps
run in the window, times hop / sample rate, over the window's seconds."""


def read(rec):
    return rec["train_frames"] * rec["hop_s"] / rec["window_s"]
