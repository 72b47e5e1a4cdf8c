"""The benchmark of `vsc22_tpu_torch` on NVIDIA GPUs.

`run.py` is the entry point (`python3 portbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`). Everything that belongs to one
model configuration, one traffic mix or one per-layer metric is a file of
its own, found by the name `BENCHMARK.json` gives it:

  configs/<config>.json   sizes, precision, source, cuts
  tasks/<task>.py         the task a configuration names (build, one unit
                          of work, the correctness judge)
  traffic/<traffic>.json  parameters read by `traffic/generate.py`
  limits/<cell>.json      each number the cell's judge compares, its limit
  metrics/<metric>.py     a per-layer reader of the traced window

`reference/` is plain PyTorch (float32, TF32 off) that imports nothing of
the program; `yardstick/` holds the peaks, the operation and byte counts
and the trace reduction.
"""
