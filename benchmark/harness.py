"""The harness: finds a cell's files by name, starts one process a chip,
runs the cell's loop, reads the per-layer metrics of a traced run, judges
the comparison and prints the result line.

Everything that belongs to one cell lies in files named after it:
BENCHMARK.json's workload names a configuration (configs/<file>) and a
traffic file (traffic/<traffic>.json), whose "loop" names the loop
(loops/<loop>.py); limits/<workload>.json holds the comparison's limits;
each per-layer metric is read by metrics/<metric>.py.  A new cell, traffic
mix or metric is a new file here and an entry in BENCHMARK.json.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names no process of the benchmark may hold: JAX and
# the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "raytpu")
CHILD_WAIT_S = 120


class WindowClosed(Exception):
    """Raised from a loop's iteration to end the measured window."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_cell(root: Path, workload: str) -> dict:
    """The workload's entry with its configuration, traffic and limits
    loaded, and the metrics it reports, from BENCHMARK.json at `root`."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "benchmark"
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"]
                                      in moved else [])]
    return dict(
        cell=cell,
        config=json.loads((root / configs[cell["config"]]["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{workload}.json").read_text()),
        end_to_end=e2e, per_layer=per_layer,
        loop=bench / "loops",
        metrics=bench / "metrics")


class Run:
    """One rank's view of a run: the cell's files, the seed, the window's
    clock and the traced run's profiler.  Loops call start_window() once
    set-up is done, mark() at every iteration's end, and stop() to ask
    whether the window has closed (every rank gets the same answer)."""

    def __init__(self, found: dict, seed: int, seconds: float, trace: bool,
                 rank: int, world: int, device, t0: float):
        self.__dict__.update(found)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.rank, self.world, self.device, self.t0 = rank, world, device, t0
        self.window_start = None
        self.prof = None
        self.summary = None

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        import torch

        if self.on_card:
            torch.cuda.synchronize(self.device)

    def start_window(self) -> float:
        import torch

        self.sync()
        if self.on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.on_card else [])
            self.prof = profile(activities=activities)
            self.prof.start()
            self.mark()
        self.window_start = time.perf_counter()
        self.setup_s = self.window_start - self.t0
        return self.window_start

    def mark(self):
        if self.prof is not None:
            import torch

            from benchmark.trace import MARK

            with torch.profiler.record_function(MARK):
                pass

    def stop(self, now: float, iterations: int) -> bool:
        """Whether the window closes after `iterations` iterations at
        `now`: its seconds have passed, or a traced run has traced the
        traffic's trace_iterations."""
        done = now - self.window_start >= self.seconds or (
            self.trace and iterations >= self.traffic["trace_iterations"])
        if self.world > 1:
            import torch
            import torch.distributed as dist

            flag = torch.tensor([int(done)], device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            done = bool(flag.item())
        if done and self.prof is not None:
            self.sync()
            self.prof.stop()
            from benchmark.trace import summarize

            self.summary = summarize(self.prof, self.on_card)
            self.prof = None
        return done

    def peak_bytes(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.on_card else 0

    def gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def all_reduce(self, tensors: list) -> list:
        """The tensors summed over the ranks (in float64)."""
        if self.world == 1:
            return tensors
        import torch
        import torch.distributed as dist

        flat = torch.cat([t.reshape(-1).double() for t in tensors])
        dist.all_reduce(flat)
        return [b.reshape(t.shape).to(t.dtype) for b, t in
                zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]

    def pixel_share(self) -> tuple:
        """This rank's share of the frame's pixels for the reference, as
        (first, count)."""
        r = self.config["render"]
        p = r["width"] * r["height"]
        per = -(-p // self.world)
        first = min(self.rank * per, p)
        return first, min(per, p - first)


def quantile(values, q: float) -> float:
    """The nearest-rank q-quantile."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def end_to_end(out: dict, peaks: list, setup_s: float, names: list) -> dict:
    """The end-to-end values a loop's output gives, for the metric `names`
    of the cell: a name ending in "mrays_per_s" is the window's rate of
    camera rays, whichever kind of iteration the cell names it for."""
    rate = out["rays"] * out["iterations"] / out["window_s"] / 1e6
    values = {"iter_ms_p95": quantile(out["iter_s"], 0.95) * 1e3,
              "peak_gib": max(peaks) / 2 ** 30,
              "setup_s": setup_s}
    values.update({n: rate for n in names if n.endswith("mrays_per_s")})
    return values


def device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or why
    it could not be read."""
    if device.type != "cuda":
        return "cpu"
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index}"],
                             capture_output=True, text=True, timeout=30)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_rank(found: dict, args, rank: int, world: int, device, t0: float):
    """Run the cell on this rank.  Rank 0 returns the result line's dict
    (the compared numbers beside their limits under "check") and every
    number the comparison read; the others return None."""
    from benchmark import compare

    if world > 1:
        import torch.distributed as dist

        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=args.init, world_size=world,
                                rank=rank)
    run = Run(found, args.seed, args.seconds, bool(args.trace), rank, world,
              device, t0)
    loop = load_module(found["loop"] / f"{found['traffic']['loop']}.py",
                       f"benchmark_loop_{found['traffic']['loop']}")
    out = loop.run(run)
    peaks = run.gather(out["peak_bytes"])
    summaries = run.gather(run.summary)
    work = run.gather(out.get("work"))
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    if rank != 0:
        return None
    limits = found["limits"]
    numbers = out["numbers"]
    result = {"correct": compare.judge(numbers, limits), "attempted": out["iterations"],
              "failed": out["failed"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": device_name(device), "count": world,
           "memory_peak_bytes": max(peaks)}
    if run.trace:
        from benchmark.trace import TraceView, breakdown

        if any(s is None for s in summaries):
            raise RuntimeError("the traced window recorded no device activity")
        facts = dict(out["facts"], config=found["config"],
                     power_limit=power_limit(device), work=_sum_work(work))
        view = TraceView(summaries, facts)
        metrics = {}
        for m in found["per_layer"]:
            reader = load_module(found["metrics"] / f"{m['name']}.py",
                                 f"benchmark_metric_{m['name']}")
            value = reader.read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        dev["busy_s"] = view.mean_over_ranks(lambda s: s["busy_ns"]) / 1e9
        dev["window_s"] = view.mean_over_ranks(lambda s: s["window_ns"]) / 1e9
        result["device"] = dev
        result["breakdown"] = breakdown(summaries[0])
        print(f"power limit: {facts['power_limit']}", file=sys.stderr)
    else:
        values = end_to_end(out, peaks, run.setup_s,
                            [m["name"] for m in found["end_to_end"]])
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in found["end_to_end"]}
        result["device"] = dev
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in limits}
    return result, numbers


def _sum_work(works: list) -> dict:
    total = {}
    for w in works:
        for k, v in (w or {}).items():
            total[k] = total.get(k, 0) + v
    return total


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refused() -> bool:
    """Whether this process holds a forbidden module, named on stderr."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
    return bool(found)


def finish(result: dict, readings: dict | None = None) -> int:
    """Print the numbers read (`readings`, those not compared first) and
    the compared numbers beside their limits last on stderr, and the result
    line last on stdout; refuse (exit 3, no line) if a forbidden module was
    loaded."""
    readings = readings or {}
    if refused():
        return 3
    for k, v in readings.items():
        if k not in result["check"]:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # A rank the launcher started: its rank, the world and the rendezvous.
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(found: dict, args, device, t0: float) -> int:
    """A rank the launcher started: run the cell, and exit 3 if the rank
    holds a forbidden module once the window has closed (the launching
    rank then prints no line)."""
    run_rank(found, args, args.rank, args.world, device, t0)
    return 3 if refused() else 0


def main(argv, t0: float) -> int:
    args = parse(argv)
    try:
        found = find_cell(ROOT, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    chips = found["cell"]["chips"]
    import torch

    # One process a chip, with one CPU thread for its operators.
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if args.rank is not None:  # a rank the launcher started
        torch.cuda.set_device(args.rank)
        return rank_main(found, args, torch.device("cuda", args.rank), t0)
    children = []
    if chips > 1:
        args.init = f"tcp://127.0.0.1:{_free_port()}"
        for r in range(1, chips):
            env = dict(os.environ, LOCAL_RANK=str(r))
            children.append(subprocess.Popen(
                [sys.executable, str(HERE / "run.py"), *argv, "--rank", str(r),
                 "--world", str(chips), "--init", args.init],
                stdout=sys.stderr.fileno(), env=env))
    try:
        torch.cuda.set_device(0)
        result, readings = run_rank(found, args, 0, chips,
                                    torch.device("cuda", 0), t0)
    finally:
        codes = []
        for c in children:
            try:
                codes.append(c.wait(timeout=CHILD_WAIT_S))
            except subprocess.TimeoutExpired:
                c.kill()
                codes.append(c.wait())
    if any(codes):
        print(f"benchmark: ranks exited with {codes}", file=sys.stderr)
        return 1
    return finish(result, readings)
