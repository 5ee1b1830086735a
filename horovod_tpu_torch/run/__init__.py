"""The launcher: ``python -m horovod_tpu_torch.run`` and :func:`run`.

The port of ``horovod_tpu/run``'s fixed path (``hvdrun``). The elastic
driver and the NIC probe are ROADMAP A12b.
"""

from .run import check_build, main, parse_args, run, run_commandline  # noqa: F401
