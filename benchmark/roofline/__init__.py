"""The yardstick of the kernels' rooflines: the card's peaks and the
dense tracer's operation counts, frozen copies of chip_smoke.py:220-221
and :366-482 as they stood when the benchmark was written.

FWD_OPS and ADJ_OPS count fp32 operations (+, -, *, /, sqrt, compare,
select and min/max: one each) per unit of work, counted by hand from
raytpu_torch/csrc/trace_common.cuh (forward) and trace_bwd.cu (adjoint).
A sphere test counts the 21 operations every test does, not the 14 a real
root adds; a spawning node's adjoint counts its Fresnel adjoint (50) even
under total internal reflection, where it is skipped.  The units are
counted by the benchmark's reference (reference.tracer.trace_level's
`work`), over the masks of its own forward.
"""

PEAK_FP32 = 67e12     # H100 SXM fp32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s

FWD_OPS = dict(sample=23, node=13, sphere=21, miss=3, live=36, light=21,
               shadow=22, shadow_sphere=37, lit=9, spawn=138, container=11,
               refl=30)
ADJ_OPS = dict(miss=6, live=150, shaded=45, lit=65, spawn=80, refl=97,
               refr=70)


def new_work() -> dict:
    return dict.fromkeys(list(FWD_OPS) + list(ADJ_OPS), 0)


def operations(work: dict, backward: bool) -> int:
    ops = sum(FWD_OPS[k] * work[k] for k in FWD_OPS)
    if backward:
        ops += sum(ADJ_OPS[k] * work[k] for k in ADJ_OPS)
    return ops


def bound_s(work: dict, n_tbl: int, pixels: int, backward: bool):
    """(least seconds, "operations" or "bytes") for one frame's forward or
    backward: the larger of its operations over the fp32 peak and its
    bytes (tables and pixels, each once) over the memory rate."""
    ops = operations(work, backward)
    nbytes = 4 * (2 * n_tbl + 3 * pixels)
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def table_floats(n_spheres: int, n_lights: int) -> int:
    """Floats of the scene tables K1 and K2 read: 12 a sphere, 6 a light,
    5 for the background."""
    return 12 * n_spheres + 6 * n_lights + 5
