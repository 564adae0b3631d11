"""A whole run on the CPU at a tiny size, with the look for a card skipped:
its result line as the contract has it, ``correct`` true; ``correct``
false with the timed path broken underneath (an image altered where it is
produced; a step that leaves the state unchanged; half of the batch left
out of the loss, its mean taken over the rest); and the control, the
reference one precision below in the program's place, failing the limits.
The harness without a card, or without the port, exits with no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gar_bench import control, run, spec
from gar_bench.compare import judge
from gar_bench.tests import tiny

ROOT = os.path.dirname(spec.HERE)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.layout(tmp_path_factory.mktemp("tiny"))


def _run(root, capsys, workload, seed=11):
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.2"],
                  root=root, device=CPU, base=root)
    cap = capsys.readouterr()
    assert rc == 0, cap.err[-2000:]
    return json.loads(cap.out.strip().splitlines()[-1]), cap.err


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_a_sound_run_is_correct(root, capsys, workload):
    out, err = _run(root, capsys, workload, seed=2**31 + 77)
    assert out["correct"] is True
    assert list(out)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert all(set(v) == {"value", "limit"} for v in out["check"].values())
    assert err.strip().splitlines()[-1].startswith("check ")


def test_an_altered_image_is_not_correct(root, capsys, monkeypatch):
    from stylerenderer_tpu_torch.models import GeneratorWithMap

    synth = GeneratorWithMap.synthesize

    def altered(self, *a, **k):
        return torch.flip(synth(self, *a, **k), dims=(3,))  # mirrored where produced
    monkeypatch.setattr(GeneratorWithMap, "synthesize", altered)
    out, _ = _run(root, capsys, tiny.RENDER)
    assert out["correct"] is False


def test_a_wrong_pyramid_is_not_correct(root, capsys, monkeypatch):
    from stylerenderer_tpu_torch.models import GeneratorWithMap

    pyr = GeneratorWithMap.normal_pyramid

    def shifted(self, mesh, *a):
        maps = pyr(self, mesh, *a)
        return [torch.roll(m, 1, dims=2) for m in maps]
    monkeypatch.setattr(GeneratorWithMap, "normal_pyramid", shifted)
    out, _ = _run(root, capsys, tiny.RENDER)
    assert out["correct"] is False and out["check"]["pyramid_off_share"]["value"] > 0.01


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(root, capsys, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out, _ = _run(root, capsys, tiny.INVERT)
    assert out["correct"] is False and out["check"]["change_gap"]["value"] > 0.9


def test_half_the_batch_left_out_is_not_correct(root, capsys, monkeypatch):
    import stylerenderer_tpu_torch.inversion.project as proj

    class HalfMean:
        """``torch`` for the projector, whose batch means take the first
        half of the batch only."""

        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def mean(x, *a, **k):
            if x.ndim == 4 and not a and not k:
                x = x[: x.shape[0] // 2]
            return torch.mean(x, *a, **k)
    monkeypatch.setattr(proj, "torch", HalfMean())
    out, _ = _run(root, capsys, tiny.INVERT)
    assert out["correct"] is False


def test_the_control_is_not_correct_render(root):
    wl = spec.workload(spec.benchmark(root), tiny.RENDER)
    numbers = control.readings(wl, 5, None, 20, base=root, device=CPU)
    assert not judge(numbers, spec.limits(tiny.RENDER, root))[0]


def test_the_control_is_not_correct_invert(tmp_path):
    """At the cell's widths, mesh and size, on a batch of 2: below them the
    bfloat16 control's gradients stay near the program's."""
    root = tiny.layout(tmp_path)
    tiny._dump(root, "configs", tiny.INVERT, spec.config("gar256"))
    traffic = spec.traffic("invert.b32")
    traffic["batch"] = 2
    tiny._dump(root, "traffic", tiny.INVERT, traffic)
    wl = spec.workload(spec.benchmark(root), tiny.INVERT)
    numbers = control.readings(wl, 5, None, 20, base=root, device=CPU)
    assert not judge(numbers, spec.limits(tiny.INVERT, root))[0]


def test_the_half_batch_fault_in_the_reference_fails(root):
    wl = spec.workload(spec.benchmark(root), tiny.INVERT)
    numbers = control.readings(wl, 5, "half_batch", 20, base=root, device=CPU)
    assert not judge(numbers, spec.limits(tiny.INVERT, root))[0]


def _cli(cwd, *extra):
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "gar_bench", "--workload", "gar256.invert.b32",
                           "--seed", "1", "--seconds", "1", *extra], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "gar_bench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
