"""One short run of every cell on a CUDA card, at the cell's own sizes.
Each test skips, with a reason, where there is no card:

    python3 -m pytest -q jpegbench/tests/test_jpegbench_card.py
"""

import json

import pytest
import torch

from jpegbench import harness as H
from jpegbench import run as R


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark never falls back to the CPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", [w["name"] for w in H.load_benchmark()["workloads"]])
def test_a_short_run_of_each_cell_is_correct(cuda, capsys, cell):
    rc = R.main(["--workload", cell, "--seed", "4100000001", "--seconds", "3", "--trace", "1"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"] is True
    assert result["device"]["busy_s"] > 0
    assert result["metrics"]


def test_without_a_card_a_run_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = R.main(["--workload", "stream_2048_420", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
