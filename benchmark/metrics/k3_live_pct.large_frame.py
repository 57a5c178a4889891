"""k3_live_pct.large_frame: the share of K3's launched slots that hold a
live ray, in %, in the large-scene frame cell: 100 x the program's counter
wf.live / wf.slots over the traced window (every level of every chunk of
every frame), from raytpu_torch.utils.profiling's recorder (rank 0's).
None where the program records no counters or launches no K3 slot."""


def read(view):
    from raytpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counters = profiling.counters()
    slots = counters.get("wf.slots", 0)
    if slots == 0:
        return None
    return 100.0 * counters.get("wf.live", 0) / slots
