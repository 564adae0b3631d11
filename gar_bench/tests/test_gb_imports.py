"""What the benchmark loads: the harness, its traffic, metrics, loops and
the port load no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``stylerenderer_tpu`` (whole names: the port's own name begins
with the last), also through a whole run; the reference loads nothing of the
port. Each in a fresh interpreter."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHECK = """
import sys
bad = sorted({m.split('.')[0] for m in sys.modules} & set(%r))
print('LOADED', ','.join(bad))
"""


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return [l for l in out.stdout.splitlines() if l.startswith("LOADED")][-1]


HARNESS = """
import glob, os, importlib
import gar_bench, gar_bench.run, gar_bench.control, gar_bench.trace, gar_bench.spec
import gar_bench.flops, gar_bench.pyramid_work, gar_bench.peaks, gar_bench.inputs
from gar_bench import spec
for p in glob.glob(os.path.join(spec.HERE, 'loops', '*.py')):
    n = os.path.basename(p)[:-3]
    if n != '__init__':
        spec.loop(n)
for p in glob.glob(os.path.join(spec.HERE, 'metrics', '*.py')):
    n = os.path.basename(p)[:-3]
    if n != '__init__':
        spec.metric(n)
import stylerenderer_tpu_torch, stylerenderer_tpu_torch.models, stylerenderer_tpu_torch.inversion
import stylerenderer_tpu_torch.face3d
"""


def test_harness_and_port_load_no_jax():
    line = _run(HARNESS + CHECK % (("jax", "jaxlib", "flax", "stylerenderer_tpu"),))
    assert line == "LOADED ", line


def test_a_whole_run_loads_no_jax(tmp_path):
    code = (f"import torch\nfrom gar_bench import run\nfrom gar_bench.tests import tiny\n"
            f"root = tiny.layout({str(tmp_path)!r})\n"
            f"for w in (tiny.RENDER, tiny.INVERT):\n"
            f"    assert run.main(['--workload', w, '--seed', '3', '--seconds', '0.1'], "
            f"root=root, device=torch.device('cpu'), base=root) == 0\n")
    line = _run(code + CHECK % (("jax", "jaxlib", "flax", "stylerenderer_tpu"),))
    assert line == "LOADED ", line


def test_reference_loads_nothing_of_the_port():
    code = """
import gar_bench.reference.gar, gar_bench.reference.raster, gar_bench.reference.geometry
import gar_bench.reference.invert, gar_bench.reference.render, gar_bench.reference.lowp
import gar_bench.inputs, gar_bench.flops, gar_bench.pyramid_work
"""
    line = _run(code + CHECK % (("jax", "jaxlib", "flax", "stylerenderer_tpu",
                                 "stylerenderer_tpu_torch"),))
    assert line == "LOADED ", line
