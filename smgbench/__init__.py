"""The benchmark of smg_tpu_torch, the PyTorch and CUDA port of SMG.

One command runs one cell once and prints one JSON line:

    python3 -m smgbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the root of the checkout names the cells, the
configurations and the metrics; each of those is a file of its own here,
found by its name: `configs/<config>.json` (sizes and settings as run),
`traffic/<traffic>.json` (the generator's parameters), `workloads/<cell>.json`
(the entry that drives the program, its batch and the limits of the
comparison that decides `correct`), `entries/<entry>.py` (set-up, one
call, the outputs judged) and `metrics/<metric>.py` (one reader each).
`reference/` holds the plain float32 reference that the outputs are judged
against; it imports nothing of the program.
"""
