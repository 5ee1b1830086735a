"""The launcher: ``python -m horovod_tpu_torch.run`` and :func:`run`.

The port of ``horovod_tpu/run``'s fixed path (``hvdrun``) with its ring NIC
probe (:mod:`.network`, :mod:`.probe`), and the elastic driver
(:mod:`.elastic_driver`) with its journal (:mod:`.journal`) and the
self-driving policies (:mod:`.selfdrive`).
"""

from .run import check_build, main, parse_args, run, run_commandline  # noqa: F401
