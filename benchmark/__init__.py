"""The benchmark of raytpu_torch, the PyTorch and CUDA port, on NVIDIA
H100 cards: `python3 benchmark/run.py --workload NAME --seed N --seconds S
--trace 0|1` from the root of a checkout.  BENCHMARK.json names the cells;
each cell's configuration, traffic and limits, and each per-layer metric's
reader, are files found here by name."""
