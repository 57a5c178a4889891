"""host_ms.frame: the host's own time a frame, in ms: the traced window
less the time the host thread waited in CUDA synchronisation and
device-to-host copies, over the frames; the mean over ranks."""


def read(view):
    return view.mean_over_ranks(
        lambda s: view.per_step_ms(s, s["window_ns"] - s["host_wait_ns"]))
