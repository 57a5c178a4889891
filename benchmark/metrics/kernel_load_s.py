"""kernel_load_s: the seconds the process spent loading the program's
kernel libraries, nvcc's builds included where a checkout has none yet
(the program's counter kernel.load_s, kept whether or not a profiler
records), from raytpu_torch.utils.profiling (rank 0's).  None where the
program keeps no such counter."""


def read(view):
    from raytpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    return float(profiling.counters().get("kernel.load_s", 0.0))
