"""On the card (``python -m pytest gar_bench/tests -m gpu``; it skips without
one): the training cell's tiny traffic (a batch of 4, cycles of 4 steps) on
its configuration at full width runs correct, untraced and traced, and the
traced run reads the R1 and path steps' device time, which the autograd
engine's thread launches."""

import json

import pytest
import torch

from gar_bench import run, spec
from gar_bench.tests import tiny

CELL = "gar256gan.train.b16"


@pytest.mark.gpu
def test_tiny_traffic_at_full_width(tmp_path, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root, name = tiny.layout(tmp_path), tiny.name(CELL)
    tiny._dump(root, "configs", name, spec.config("gar256gan"))
    outs = []
    for trace in (0, 1):
        rc = run.main(["--workload", name, "--seed", str(2**33 + 71 + trace), "--seconds", "2",
                       "--trace", str(trace)], root=root, base=root)
        assert rc == 0
        outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert all(o["correct"] is True and o["device"]["platform"] == "gpu" for o in outs), [
        o["check"] for o in outs]
    traced = outs[1]["metrics"]
    assert traced["r1_ms.train"]["value"] > 0 and traced["path_ms.train"]["value"] > 0
