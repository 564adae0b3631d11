"""On the card (``python -m pytest gar_bench/tests -m gpu``; each skips
without one): a short run of each cell at its own size is correct, and the
control at the cell's own size fails the cell's limits."""

import json
import os

import pytest
import torch

from gar_bench import control, run, spec
from gar_bench.compare import judge

ROOT = os.path.dirname(spec.HERE)
CELLS = [w["name"] for w in spec.benchmark(ROOT)["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct(workload, capsys):
    _card()
    assert run.main(["--workload", workload, "--seed", "12345", "--seconds", "2"], root=ROOT) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(workload):
    _card()
    wl = spec.workload(spec.benchmark(ROOT), workload)
    assert not judge(control.readings(wl, 54321, None, 250), spec.limits(workload))[0]
