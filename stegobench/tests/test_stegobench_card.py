"""Each cell at a small size on the card, the CUDA kernels in the program's
place: sound runs come out correct and the TF32 control does not. Skips
without a card (decided in the fixture, never at import):

    python -m pytest stegobench/tests/test_stegobench_card.py -m cuda -q
"""

from __future__ import annotations

import time
from pathlib import Path

import pytest

from stegobench import run
from stegobench.tests.test_stegobench_drivers import SEED, SMALL

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SMALL))
def test_cell_on_the_card(card, cell):
    over = {"config": SMALL[cell]["config"],
            "traffic": {**SMALL[cell]["traffic"],
                        "trace": {"offset_s": 0.0, "length_s": None}}}
    res, _ = run.run_cell(ROOT, cell, SEED, 1.0, True, card,
                          time.perf_counter(), overrides=over)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SMALL))
def test_control_on_the_card(card, cell):
    res, _ = run.run_cell(ROOT, cell, SEED, 0.5, False, card,
                          time.perf_counter(), control=True,
                          overrides=SMALL[cell])
    assert not res["correct"], res["checks"]
