"""Per-rank entry for the ``horovod_tpu_torch.run.run()`` API: load the
pickled function, execute it, write the pickled result (the port of
``horovod_tpu/run/task_runner.py``; parity with the reference's
``run/run_task.py`` + KVStore function shipping)."""

from __future__ import annotations

import os
import pickle
import sys


def main() -> int:
    fn_path = os.environ["HOROVOD_RUN_FN_FILE"]
    result_dir = os.environ["HOROVOD_RUN_RESULT_DIR"]
    rank = int(os.environ.get("HOROVOD_RANK", "0"))
    with open(fn_path, "rb") as f:
        fn, args, kwargs = pickle.load(f)
    result = fn(*args, **kwargs)
    tmp = os.path.join(result_dir, f".result.{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(result_dir, f"result.{rank}.pkl"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
