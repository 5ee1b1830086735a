"""The bench's ``--tp`` surface (ROADMAP A6's remainder) against ``bench.py``.

- The argument errors of ``--tp``, ``--rules`` and ``--tp-overlap`` are the
  JAX bench's, word for word.
- ``--tp 2 --ranks 2`` on gloo at the smoke dims trains the composed step
  (``make_train_step(rules="gpt")``, data 1 x model 2) to the loss of the
  whole-batch DP run at the same seed, as ``tools/tp_parity`` holds the
  composed step to the whole batch (bf16 compute: rel 2e-3), with and without
  ``--tp-overlap``; its ``detail`` has the JAX bench's ``mesh``, ``rules``,
  ``wire`` (with ``per_axis``), ``step_skew`` and ``sim`` keys, the wire's
  bytes by the fusion layer's ring formula and the real cross-rank skew.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_parse():
    spec = importlib.util.spec_from_file_location("ref_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._parse_args


def _error(parse, argv, capsys) -> str:
    with pytest.raises(SystemExit) as e:
        parse(argv)
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("argv", [
    ["--tp", "1"],
    ["--rules", "gpt"],
    ["--tp-overlap"],
    ["--tp", "2", "--model", "resnet50"],
    ["--serve", "--tp", "1"],
])
def test_tp_argument_errors_are_bench_pys(argv, capsys):
    from horovod_tpu_torch import bench

    assert _error(bench.parse_args, argv + ["--device", "cpu"], capsys) == \
        _error(_ref_parse(), argv, capsys)


def test_tp_defaults_and_scan_still_refused(capsys):
    from horovod_tpu_torch import bench

    args = bench.parse_args(["--model", "transformer", "--tp", "2", "--ranks", "4",
                             "--device", "cpu"])
    assert (args.rules, args.tp, args.ranks) == ("gpt", 2, 4)
    assert "tp" not in bench.UNPORTED and list(bench.UNPORTED) == ["scan"]
    assert bench.reduction_mode(bench.parse_args(
        ["--model", "transformer", "--tp", "2", "--ranks", "2", "--zero1", "--overlap",
         "--device", "cpu"])) == \
        "overlap+streamed+zero1+tp2"
    args = bench.parse_args(["--serve", "--tp", "2", "--device", "cpu"])
    assert (args.ranks, args.model) == (2, "transformer")
    with pytest.raises(SystemExit):
        bench.parse_args(["--model", "transformer", "--tp", "2", "--ranks", "3",
                          "--device", "cpu"])


def _bench(*argv):
    env = {k: v for k, v in os.environ.items()
           if k not in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--smoke", "--device", "cpu",
         "--model", "transformer", "--num-warmup-batches", "1", *argv],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads([l for l in proc.stdout.splitlines() if l.startswith("{")][-1])["detail"]


@pytest.fixture(scope="module")
def whole_batch():
    return _bench()


@pytest.mark.parametrize("overlap", [False, True])
def test_bench_tp_matches_the_whole_batch_and_has_the_blocks(whole_batch, overlap):
    from horovod_tpu_torch.ops.fusion import ring_wire_bytes

    det = _bench("--tp", "2", "--ranks", "2", *(["--tp-overlap"] if overlap else []))
    assert abs(det["loss"] - whole_batch["loss"]) <= 2e-3 * abs(whole_batch["loss"])
    assert np.isfinite(det["loss"]) and det["n_params"] == whole_batch["n_params"]
    assert list(det)[:4] == ["total_tokens_per_sec", "n_chips", "mesh", "rules"]
    assert (det["mesh"], det["rules"], det["reduction_mode"]) == \
        ({"data": 1, "model": 2}, "gpt", "posthoc+tp2")
    wire = det["wire"]
    assert list(wire) == ["gradient_bytes", "bytes_on_wire_per_step_per_chip",
                          "full_precision_bytes_on_wire_per_step_per_chip", "savings_ratio",
                          "per_axis"]
    # The local shards: the sharded kernels halve, the rest replicate.
    assert whole_batch["wire"]["gradient_bytes"] / 2 < wire["gradient_bytes"] < \
        whole_batch["wire"]["gradient_bytes"]
    model = wire["per_axis"]["model"]
    payload = 2 * 128 * 128 * 2                      # batch 2 x 128 tokens x d 128, bf16
    assert (model["psum_payload_bytes"], model["psums_per_step"], model["tp_degree"]) == \
        (payload, 8, 2)
    assert model["bytes_on_wire_per_step_per_chip"] == 8 * ring_wire_bytes(payload, 2)
    assert model["path"] == ("collective_matmul (fused)" if overlap else "psum (classic)")
    assert wire["per_axis"]["data"] == {"bytes_on_wire_per_step_per_chip": 0,
                                        "local_gradient_bytes": wire["gradient_bytes"],
                                        "dp_degree": 1}
    skew = det["step_skew"]
    assert skew["ranks_observed"] == 2 and skew["worst_rank"] in (0, 1)
    assert 0 <= skew["p50_skew_s"] <= skew["p99_skew_s"]
    sim = det["sim"]
    assert "error" not in sim and sim["ranks"] == 1 and sim["tp"]["degree"] == 2
    assert sim["tp"]["fixed_comm_us"] > 0 and ("overlap" in sim["tp"]) == overlap
