"""Run the sharded render and training over several processes of one
machine (the counterpart of tools/multiprocess_demo.py): every process
joins one torch.distributed group, renders frames sharded, takes sharded
training steps and short sharded fits, and writes what it got, beside
the one-device results (rank 0), to an .npz of its own.

    python -m raytpu_torch.tools.multiprocess_demo        # 2 ranks sharing a card
    python -m raytpu_torch.tools.multiprocess_demo --cpu  # 2 ranks, CPU, gloo

A suite is a list of cases (SUITES).  Without --worker it starts --procs
workers (`--worker RANK`), each with a time limit, loads every rank's
results and prints each case's difference from the one-device result and
whether it is within its tolerance; it exits 1 if a worker failed or a
case is not, and 2 without a card unless --cpu is given.  Ranks sharing one card use "gloo": "nccl" refuses two
ranks on one GPU; `--device cuda --dist-backend nccl` gives a card a rank.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

KERNEL_NAMES = ("trace_fwd", "trace_bwd", "wf_level", "wf_compact",
                "wf_level_bwd", "wf_uncompact")

# Config 3 (the default scene) and config 5 (random_scene(256, seed=3)),
# as (width, height, depth, alias).
CONFIG3, CONFIG5 = (640, 480, 4, 3), (1920, 1080, 6, 3)
C5_SCENE = ("random", 256, 3)
C5_OPTS = {"chunk_rays": 1 << 22, "capacity_factor": 1.0}


def _case(name, kind, cfg, backend, interleave=False, scene=("default",),
          **kw):
    return dict(name=name, kind=kind, cfg=cfg, backend=backend,
                interleave=interleave, scene=scene, **kw)


# The CPU suite: the plain versions at tiny frames.  Render frames have an
# odd P, so the last rank's tail repeats pixel P-1.  A case's `interleave`
# None takes the program's default layout.  "drop" renders and steps a
# frame whose top half (rank 0's block) misses a transparent sphere that
# fills the bottom half (rank 1's): at one chunk of 8192 rays and capacity
# 1, rank 1 alone drops live rays.
SUITES = {
    "cpu": [
        *(_case(f"render_{b}_{m}", "render", (13, 7, 2, 2), b, m == "interleave")
          for b in ("torch", "wavefront") for m in ("block", "interleave")),
        *(_case(f"grad_{b}_{m}", "grad", (24, 16, 2, 1), b, m == "interleave",
                wf_opts={"chunk_rays": 128} if b == "wavefront" else None)
          for b in ("torch", "wavefront") for m in ("block", "interleave")),
        _case("grad_wavefront_default", "grad", (24, 16, 2, 1), "wavefront",
              None, wf_opts={"chunk_rays": 128}),
        _case("fit_torch_block", "fit", (12, 8, 1, 1), "torch", steps=2),
        _case("fit_wavefront_interleave", "fit", (12, 8, 1, 1), "wavefront",
              True, steps=2),
        _case("drop", "drop", (128, 128, 1, 1), "wavefront", scene=("drop",),
              wf_opts={"chunk_rays": 8192, "capacity_factor": 1.0}),
    ],
    # Two ranks sharing one card: config 3's frame through K1 and its step
    # through K1 + K2, config 5's step through the wavefront, timed.
    "card": [
        *(_case(f"render_cuda_{m}", "render", CONFIG3, "cuda", m == "interleave")
          for m in ("block", "interleave")),
        *(_case(f"grad_cuda_{m}", "grad", CONFIG3, "cuda", m == "interleave")
          for m in ("block", "interleave")),
        *(_case(f"grad_wavefront_{m}", "grad", CONFIG5, "wavefront",
                m == "interleave", scene=C5_SCENE, wf_opts=C5_OPTS, timed=True)
          for m in ("block", "interleave")),
    ],
}


def make_case_scene(spec, device):
    from raytpu_torch import scene as S

    if spec[0] == "random":
        return S.random_scene(spec[1], seed=spec[2], device=device)
    if spec[0] == "drop":
        mat = S.make_material(0.3, (0.2, 0.4, 0.6), (0.9, 0.9, 0.9),
                              opacity=0.0, ior=1.5)
        return S.build_scene(sphere_specs=[((0.0, -6.0, -10.0), 9.9, mat)],
                             light_specs=[((10.0, 30.0, 10.0), (0.5, 0.5, 0.5))],
                             device=device)
    return S.default_scene(device=device)


def _leaves(prefix, scene):
    from raytpu_torch.scene import LEAF_NAMES, scene_leaves

    return {f"{prefix}/{n}": t.detach().cpu().numpy()
            for n, t in zip(LEAF_NAMES, scene_leaves(scene))}


def _launches():
    from raytpu_torch.kernels.trace_cuda import TRACE_BWD, TRACE_FWD
    from raytpu_torch.kernels.wavefront import (WF_COMPACT, WF_LEVEL,
                                                WF_LEVEL_BWD, WF_UNCOMPACT)

    return (TRACE_FWD, TRACE_BWD, WF_LEVEL, WF_COMPACT, WF_LEVEL_BWD,
            WF_UNCOMPACT)


def _counted(fn):
    """fn() with every kernel's launch count set to 0 just before it;
    returns (result, {name: launches})."""
    for k in _launches():
        k.launches = 0
    out = fn()
    return out, {k.name: k.launches for k in _launches()}


def run_case(case, mesh, targets=None) -> dict:
    """One case on this rank -> {key: numpy array}.  A "grad" case's target
    is targets[name] where given, else half the one-device frame; a timed
    one needs a card."""
    import torch

    from raytpu_torch.config import RenderConfig
    from raytpu_torch.examples.fit_scene import perturb
    from raytpu_torch.grad import (fit_scene, loss_and_grad,
                                   loss_and_grad_sharded,
                                   loss_and_grad_wavefront)
    from raytpu_torch.render import (DroppedRaysError, render_sharded,
                                     render_single)
    from raytpu_torch.scene import LEAF_NAMES, scene_from_leaves

    w, h, d, a = case["cfg"]
    cfg = RenderConfig(width=w, height=h, max_depth=d, alias_factor=a)
    device = mesh.device
    scene = make_case_scene(case["scene"], device)
    backend, interleave = case["backend"], case["interleave"]
    wf_opts = case.get("wf_opts")
    dense = "cuda" if device.type == "cuda" else "torch"
    out = {}
    if case["kind"] == "render":
        (img, info), launches = _counted(lambda: render_sharded(
            scene, cfg, mesh, backend, wf_opts, True, "raise", interleave))
        out.update(image=img.cpu().numpy(), dropped=info["dropped"])
        if mesh.rank == 0:
            out["ref"] = render_single(scene, cfg, backend, wf_opts).cpu().numpy()
    elif case["kind"] == "grad":
        if targets and case["name"] in targets:
            target = torch.tensor(targets[case["name"]], device=device)
        else:
            target = 0.5 * render_single(scene, cfg, dense).reshape(-1, 3)
        step = lambda: loss_and_grad_sharded(  # noqa: E731
            scene, cfg, target, mesh, backend, interleave, wf_opts,
            return_info=True)
        if case.get("timed"):
            step()
            times = []
            for _ in range(3):
                torch.cuda.reset_peak_memory_stats(device)
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize(device)
                times.append((time.perf_counter() - t0) * 1e3)
            out.update(ms=np.median(times),
                       peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
        (loss, grads, info), launches = _counted(step)
        out.update(loss=float(loss), dropped=info["dropped"],
                   **_leaves("grad", grads))
        if mesh.rank == 0:
            if backend == "wavefront":
                ref_loss, ref_grads = loss_and_grad_wavefront(
                    scene, cfg, target, **(wf_opts or {}))
            else:
                ref_loss, ref_grads = loss_and_grad(scene, cfg, target, backend)
            out.update(target=target.cpu().numpy(), ref_loss=float(ref_loss),
                       **_leaves("ref_grad", ref_grads))
    elif case["kind"] == "fit":
        target = render_single(scene, cfg, dense).reshape(-1, 3)
        start = perturb(scene, geometry=False)
        trainable = scene_from_leaves([n in ("spheres.matte", "lights.col")
                                       for n in LEAF_NAMES])
        fit = lambda m: fit_scene(  # noqa: E731
            start, cfg, target, steps=case["steps"], mesh=m, trainable=trainable,
            backend=backend, interleave=interleave, wf_opts=wf_opts,
            optimizer=lambda p: torch.optim.Adam(p, lr=2e-2, eps=1e-16))
        (fitted, losses), launches = _counted(lambda: fit(mesh))
        out.update(losses=np.asarray(losses), **_leaves("scene", fitted))
        if mesh.rank == 0:
            out["ref_losses"] = np.asarray(fit(None)[1])
    elif case["kind"] == "drop":
        from raytpu_torch.kernels.wavefront import render_pixels_wavefront
        from raytpu_torch.parallel.mesh import pixel_set

        offset, count, stride = pixel_set(mesh, cfg, interleave)
        _, mine = render_pixels_wavefront(scene, cfg, return_info=True,
                                          offset=offset, count=count,
                                          shard_stride=stride, **wf_opts)
        out["local_dropped"] = int(mine["dropped"])
        target = torch.zeros((cfg.num_pixels, 3), device=device)
        calls = {"render": lambda: render_sharded(
                     scene, cfg, mesh, backend, wf_opts, on_drop="raise",
                     interleave=interleave),
                 "grad": lambda: loss_and_grad_sharded(
                     scene, cfg, target, mesh, backend, interleave, wf_opts)}
        for name, call in calls.items():
            try:
                call()
                out[f"{name}_raised"] = False
            except DroppedRaysError:
                out[f"{name}_raised"] = True
        launches = {}
    out.update({f"launches/{k}": v for k, v in launches.items()})
    return out


def worker(rank: int, procs: int, init: str, suite: str, device: str,
           dist_backend: str, out_dir: str) -> int:
    import torch

    torch.set_num_threads(2)
    from raytpu_torch.parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed(init, procs, rank, backend=dist_backend)
    try:
        if device == "cuda":  # a card a rank
            device = f"cuda:{rank % torch.cuda.device_count()}"
        mesh = make_mesh(device)
        if (mesh.rank, mesh.size) != (rank, procs):
            raise RuntimeError(f"joined as rank {mesh.rank} of {mesh.size}, "
                               f"not {rank} of {procs}")
        path = os.path.join(out_dir, "targets.npz")
        targets = dict(np.load(path)) if os.path.exists(path) else None
        results = {}
        for case in SUITES[suite]:
            for key, value in run_case(case, mesh, targets).items():
                results[f"{case['name']}/{key}"] = np.asarray(value)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def spawn(suite: str = "cpu", procs: int = 2, device: str = "cpu",
          dist_backend: str = "gloo", out_dir: str | None = None,
          timeout: float = 600.0, targets: dict | None = None) -> list[dict]:
    """Run `suite` over `procs` worker processes joined by a file:// group
    in `out_dir` (default: a new temporary directory) -> every rank's
    results, {case/key: array}.  `targets` maps "grad" cases to their (P, 3)
    targets.  Raises RuntimeError, with the workers' output, if one fails
    or outlives `timeout` seconds (then all are killed)."""
    out_dir = tempfile.mkdtemp(prefix="raytpu_mp_") if out_dir is None else out_dir
    os.makedirs(out_dir, exist_ok=True)
    if targets:
        np.savez(os.path.join(out_dir, "targets.npz"), **targets)
    init = "file://" + os.path.join(os.path.abspath(out_dir), "rendezvous")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # One machine: gloo's sockets on the loopback interface.
    env = dict(os.environ, PYTHONPATH=root, GLOO_SOCKET_IFNAME="lo")
    cmd = [sys.executable, "-m", "raytpu_torch.tools.multiprocess_demo",
           "--procs", str(procs), "--init", init, "--suite", suite,
           "--device", device, "--dist-backend", dist_backend, "--out", out_dir]
    workers = [subprocess.Popen(cmd + ["--worker", str(r)], cwd=root, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True) for r in range(procs)]
    deadline = time.monotonic() + timeout
    logs, failed = [], False
    try:
        for w in workers:
            try:
                logs.append(w.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))[0])
            except subprocess.TimeoutExpired:
                failed = True
                break
            failed |= w.returncode != 0
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.communicate()
    if failed:
        raise RuntimeError(f"multiprocess_demo {suite}: a worker failed or "
                           f"timed out after {timeout} s:\n" + "\n".join(logs))
    results = []
    for r in range(procs):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            results.append({k: z[k] for k in z.files})
    return results


def case_summary(results: list[dict], case: dict) -> dict:
    """How `case` compares with the one-device result: the largest
    difference over the scale of the reference, whether every rank holds
    the same bits, and whether it is within the case's tolerance (frames
    bit for bit; a loss within rtol 1e-5 and every gradient leaf within
    2e-3 x max |one-device|; drops raised on every rank together)."""
    from raytpu_torch.scene import LEAF_NAMES

    name, r0 = case["name"], results[0]
    get = lambda r, k: r[f"{name}/{k}"]  # noqa: E731
    same = lambda k: all(np.array_equal(get(r, k), get(r0, k))  # noqa: E731
                         for r in results)
    s = {"name": name}
    if case["kind"] == "render":
        img, ref = get(r0, "image"), get(r0, "ref")
        s.update(max_abs_err=float(np.abs(img - ref).max()),
                 scale=float(np.abs(ref).max()),
                 bit_identical=bool(np.array_equal(img, ref)),
                 ranks_agree=same("image"),
                 dropped=int(get(r0, "dropped")))
        s["ok"] = s["bit_identical"] and s["ranks_agree"] and s["dropped"] == 0
    elif case["kind"] == "grad":
        loss, ref_loss = float(get(r0, "loss")), float(get(r0, "ref_loss"))
        errs = {}
        for leaf in LEAF_NAMES:
            a, b = get(r0, f"grad/{leaf}"), get(r0, f"ref_grad/{leaf}")
            errs[leaf] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        s.update(loss=loss, ref_loss=ref_loss,
                 loss_rel_err=abs(loss - ref_loss) / max(abs(ref_loss), 1e-30),
                 grad_rel_err=max(errs.values()), worst_leaf=max(errs, key=errs.get),
                 ranks_agree=all(same(f"grad/{leaf}") for leaf in LEAF_NAMES)
                 and same("loss"),
                 dropped=int(get(r0, "dropped")))
        if case.get("timed"):
            s.update(ms=[float(get(r, "ms")) for r in results],
                     peak_gib=[float(get(r, "peak_gib")) for r in results])
        s["ok"] = (s["loss_rel_err"] <= 1e-5 and s["grad_rel_err"] <= 2e-3
                   and s["ranks_agree"] and s["dropped"] == 0)
    elif case["kind"] == "fit":
        losses, ref = get(r0, "losses"), get(r0, "ref_losses")
        s.update(losses=losses.tolist(), ref_losses=ref.tolist(),
                 loss_rel_err=float(np.max(np.abs(losses - ref) / np.abs(ref))),
                 ranks_agree=all(same(f"scene/{leaf}") for leaf in LEAF_NAMES))
        s["ok"] = s["loss_rel_err"] <= 1e-5 and s["ranks_agree"]
    else:
        local = [int(get(r, "local_dropped")) for r in results]
        s.update(local_dropped=local,
                 raised={k: [bool(get(r, f"{k}_raised")) for r in results]
                         for k in ("render", "grad")})
        s["ok"] = (0 < sum(d > 0 for d in local) < len(local)
                   and all(all(v) for v in s["raised"].values()))
    s["launches"] = {k: int(get(r0, f"launches/{k}")) for k in KERNEL_NAMES
                     if f"{name}/launches/{k}" in r0}
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="run the cpu suite on the CPU (default: the card "
                         "suite on cuda:0)")
    ap.add_argument("--suite", choices=sorted(SUITES), default=None,
                    help="default: cpu with --cpu, else card")
    ap.add_argument("--device", default=None,
                    help="the device every rank renders on, or 'cuda' for a "
                         "card a rank (default: cpu with --cpu, else cuda:0)")
    ap.add_argument("--dist-backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", default=None, help="directory for the .npz files")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    suite = args.suite or ("cpu" if args.cpu else "card")
    device = args.device or ("cpu" if args.cpu else "cuda:0")
    if args.worker is not None:
        return worker(args.worker, args.procs, args.init, suite, device,
                      args.dist_backend, args.out)
    import torch

    if device != "cpu" and not torch.cuda.is_available():
        print("error: no CUDA device found; pass --cpu to run on the CPU",
              file=sys.stderr)
        return 2
    results = spawn(suite, args.procs, device, args.dist_backend, args.out,
                    args.timeout)
    ok = True
    for case in SUITES[suite]:
        s = case_summary(results, case)
        ok &= s["ok"]
        print(json.dumps(s))
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
