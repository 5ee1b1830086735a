"""Shared fixtures of the benchmark's CPU tests: each cell of
``BENCHMARK.json`` at smoke widths, and the card's marker."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from hvdbench import common  # noqa: E402

SMOKE = {
    "gpt2": ({"n_embd": 64, "n_head": 2, "n_layer": 2, "vocab_size": 512, "n_positions": 64},
             {"seq_len": 64, "batch_per_card": 4}),
    "resnet": ({"layers": [1, 1, 1, 1], "width": 8, "image_size": 64, "num_classes": 10},
               {"batch_per_card": 8}),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


def smoke_cell(name: str, ranks: int = 2) -> dict:
    """The cell ``name`` as the manifest builds it, at smoke widths, with
    at most ``ranks`` ranks."""
    cell = common.cell(name)
    config_over, traffic_over = SMOKE[cell["config"]["family"]]
    cell["config"].update(config_over)
    cell["traffic"].update(traffic_over)
    cell["traffic"]["ranks"] = min(int(cell["traffic"]["ranks"]), ranks)
    return cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda", 0)
