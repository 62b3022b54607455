"""The benchmark of the PyTorch/CUDA port (``repro_torch``): PoFEL trainer
rounds at full width on one H100, driven by the data files beside this
package. ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout."""
