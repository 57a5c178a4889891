"""The live-ray compaction's tile functions (K5), run on the CPU.

raytpu_torch/csrc/wf_compact.cu compiled as plain C++ gives
raytpu_wf_compact_host, which runs the scan kernel's tile functions
(tile_child's striped order, load_intensity, place_child, write_counts)
over every tile in order and then the tail kernel's (tail_slot) over the
slots past the kept prefix.  It is held bit for bit against the plain
version, compact_torch (state, pids, dropped, n_kept and dst), on the
inputs the kernel must take: no children, fewer than one tile, every child
dead, every child live, a capacity below the live count (the drop path)
and one above the children, and enough tiles (4096 children each) that
the kept prefix crosses several of them.  The look-back between tiles
runs only on a card (tests/test_torch_cuda.py, chip_smoke.py phases 10
and 13).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from raytpu_torch.kernels.wavefront import N_STATE, compact_torch

torch.set_num_threads(2)

SOURCE = Path(__file__).resolve().parent.parent / "raytpu_torch" / "csrc" / "wf_compact.cu"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU harness of the CUDA sources")
    lib_path = tmp_path_factory.mktemp("compact") / "libwf_compact_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(lib_path), str(SOURCE)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.raytpu_wf_compact_host.argtypes = [_P, _LL, _P, _LL, _I, _P, _P, _P, _P]
    lib.raytpu_wf_compact_host.restype = None
    lib.raytpu_wf_compact_tile.restype = ctypes.c_int
    return lib


def host_compact(lib, children, pid, cap, n_slots, with_dst):
    kids = children.shape[1]
    state = torch.full((N_STATE, cap), float("nan"))
    out_pid = torch.full((cap,), -7, dtype=torch.int32)
    dst = torch.full((kids,), -7, dtype=torch.int32) if with_dst else None
    counts = torch.full((3,), -7, dtype=torch.int64)
    lib.raytpu_wf_compact_host(children.data_ptr(), kids, pid.data_ptr(), cap,
                               n_slots, state.data_ptr(), out_pid.data_ptr(),
                               dst.data_ptr() if with_dst else None,
                               counts.data_ptr())
    out = (state, out_pid, counts[0], counts[1])
    return (*out, dst) if with_dst else out


def seeded_children(parents, live_frac, seed):
    """(10, 2 * parents) children as K3 writes them (a dead child is ten
    exact zeros, a live one has a nonzero intensity channel) and the
    parents' pids."""
    rng = np.random.default_rng(seed)
    kids = 2 * parents
    ch = rng.normal(size=(N_STATE, kids)).astype(np.float32)
    ch[9] = rng.integers(-1, 8, kids)
    channel = rng.integers(0, 3, kids)
    ch[6:9][:, rng.random(kids) < 0.5] = 0.0  # half keep one nonzero channel
    ch[6 + channel, np.arange(kids)] = 0.5 + rng.random(kids).astype(np.float32)
    ch[:, rng.random(kids) >= live_frac] = 0.0
    pid = rng.integers(0, 1 << 20, parents).astype(np.int32)
    return torch.from_numpy(ch), torch.from_numpy(pid)


CASES = {
    # name: (parents, live fraction, capacity)
    "no children": (0, 0.5, 4096),
    "less than a tile": (300, 0.6, 1024),
    "every child dead": (3000, 0.0, 2048),
    "every child live": (3000, 1.0, 8192),
    "capacity below the live count": (5000, 0.7, 3000),
    "capacity above the children": (1000, 0.5, 9000),
    "many tiles": (9 * 2048 + 5, 0.45, 16384),
    "zero capacity": (700, 0.5, 0),
}


def same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("with_dst", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_functions_match_compact_torch(host, case, with_dst):
    parents, live_frac, cap = CASES[case]
    children, pid = seeded_children(parents, live_frac, seed=len(case))
    n_slots = 37
    got = host_compact(host, children, pid, cap, n_slots, with_dst)
    want = compact_torch(children, pid, cap, n_slots, return_dst=with_dst)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert same(a, b.to(a.dtype))
    alive = int((children[6:9] != 0).any(dim=0).sum())
    assert int(got[2]) == max(alive - cap, 0) and int(got[3]) == min(alive, cap)


def test_the_cases_span_several_tiles(host):
    """"many tiles" crosses tile seams with its kept prefix: its children
    fill 9 tiles and more."""
    tile = host.raytpu_wf_compact_tile()
    assert tile == 4096
    assert 2 * CASES["many tiles"][0] > 9 * tile
