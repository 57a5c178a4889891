"""Time two of the port's paths from the raytpu_torch package of a given
checkout, to compare two checkouts on one card in turns:

    for r in OLD NEW NEW OLD; do
        python raytpu_torch/tools/path_ab.py $r
    done

(run as a file, so that the package imported is the one under the
checkout given).  The paths: the forward-only config-5 frame through the
wavefront (random_scene(256, seed=3), 1920x1080 d6 3x3, 4M-ray chunks,
capacity 1.0), CUDA events, median of 5 after 2 warm-ups; and the config-3
training step through the kernel pair (loss_and_grad(backend="cuda") on the
fit example's perturbed geometry against the true frame), the host clock
around each synchronised step, median of 9 after 2 warm-ups.  Prints the
card and every time.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: path_ab.py CHECKOUT")
    root = str(Path(argv[0]).resolve())
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import raytpu_torch
    from raytpu_torch import grad
    from raytpu_torch.config import BENCH_CONFIGS
    from raytpu_torch.examples.fit_scene import perturb
    from raytpu_torch.kernels.trace_cuda import render_pixels_cuda
    from raytpu_torch.kernels.wavefront import render_pixels_wavefront
    from raytpu_torch.scene import default_scene, random_scene

    if not raytpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {raytpu_torch.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("path_ab: needs a CUDA device")
    dev = torch.device("cuda:0")

    def event_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def host_ms(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    def times(timer, fn, reps):
        for _ in range(2):
            fn()
        return [timer(fn) for _ in range(reps)]

    c5, c3 = BENCH_CONFIGS["config5"], BENCH_CONFIGS["config3"]
    s5 = random_scene(256, seed=3, device=dev)
    with torch.no_grad():
        frame = times(event_ms, lambda: render_pixels_wavefront(
            s5, c5, chunk_rays=1 << 22, capacity_factor=1.0), 5)
    truth = default_scene(device=dev)
    target = render_pixels_cuda(truth, c3)
    scene = perturb(truth, geometry=True)
    step = times(host_ms, lambda: grad.loss_and_grad(scene, c3, target,
                                                     backend="cuda"), 9)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    print(f"{root}: config5 wavefront frame {np.median(frame):.3f} ms "
          f"{[round(t, 3) for t in frame]}; config3 kernel-pair step "
          f"{np.median(step):.3f} ms {[round(t, 3) for t in step]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
