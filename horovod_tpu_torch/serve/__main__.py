"""``python -m horovod_tpu_torch.serve``: the serving demo.

Builds a demo-sized ``TransformerLM`` from a seed, stands up the engine and
its HTTP frontend on ``HOROVOD_SERVE_PORT`` (0 picks a free port) and
serves until interrupted; the counterpart of
``horovod_tpu/serve/__main__.py``. The geometry comes from the same ``HVD_SERVE_DEMO_*``
variables (vocab 128, d_model 64, 4 heads, 2 layers, max_len 128, seed 0
by default); every serving knob from the ``HOROVOD_SERVE_*`` environment,
the autoscaler's (``ServeScalePolicy.from_env``) too, with one autoscale
beat a second.

    python -m horovod_tpu_torch.serve                 # on the card
    python -m horovod_tpu_torch.serve --device cpu
    curl -s localhost:<port>/v1/completions -d '{"prompt": [1, 2, 3], "max_tokens": 4}'
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu to serve on the CPU; default: the card")
    args = ap.parse_args(argv)

    import torch

    from ..models.transformer import TransformerLM
    from ..run.selfdrive import ServeScalePolicy
    from ..utils.convert import param_tree
    from . import serve

    vocab = int(os.environ.get("HVD_SERVE_DEMO_VOCAB", "128"))
    d_model = int(os.environ.get("HVD_SERVE_DEMO_D_MODEL", "64"))
    n_heads = int(os.environ.get("HVD_SERVE_DEMO_HEADS", "4"))
    n_layers = int(os.environ.get("HVD_SERVE_DEMO_LAYERS", "2"))
    max_len = int(os.environ.get("HVD_SERVE_DEMO_MAX_LEN", "128"))
    seed = int(os.environ.get("HVD_SERVE_DEMO_SEED", "0"))

    model = TransformerLM(vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
                          max_len=max_len, dtype=torch.float32, device=args.device, seed=seed)
    handle = serve(param_tree(model), n_heads=n_heads, http=True, device=args.device,
                   scale_policy=ServeScalePolicy.from_env())
    print(
        f"hvd.serve: listening on :{handle.port} "
        f"(replicas={handle.engine.live_replicas()}, "
        f"vocab={vocab}, d_model={d_model}, heads={n_heads}, "
        f"layers={n_layers}, device={handle.engine.device})",
        flush=True,
    )
    try:
        while True:
            time.sleep(1.0)
            handle.engine.autoscale_beat()
    except KeyboardInterrupt:
        pass
    finally:
        handle.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
