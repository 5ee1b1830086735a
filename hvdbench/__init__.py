"""hvdbench: the benchmark of horovod_tpu_torch on NVIDIA cards.

One command runs one cell (a model configuration under a traffic mix) once:

    python3 hvdbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the sizes, dtypes and optimizer as run;
- ``families/<family>.py``: how a configuration's family is built in the
  program, its weights and inputs from the seed, and its FLOP count;
- ``reference/<family>.py``: the plain float32 PyTorch reference;
- ``traffic/<traffic>.json``: the path, the batch a card, ranks, warm-up;
- ``paths/<path>.py``: the code that runs one way of training (``graph``, ``hooks``);
- ``limits/<workload>.json``: the limits of the comparison that decides
  ``correct``, with the readings they were set from;
- ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader each.

This package imports neither JAX nor the JAX package; only ``paths/`` and
the program-side functions of ``families/`` import ``horovod_tpu_torch``,
and ``reference/`` imports nothing of it.
"""
