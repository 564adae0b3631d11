"""The benchmark of the PyTorch and CUDA port, one cell a run.

    python3 -m gar_bench --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``. A run sets up
the cell (weights and inputs drawn from the seed on the card, the program
built and warmed on the cell's shapes), measures for ``--seconds``, checks
what the timed path produced against the plain reference under
``gar_bench/reference/``, and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics), ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``: each number compared
beside its limit, which also end standard error.

It exits with another code than 0, and prints no result, when there is no
card or fewer than the cell needs (2), when the port cannot be imported
(3), and when JAX, flax or the JAX package are loaded in the process once
the window has closed (4).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from gar_bench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "stylerenderer_tpu")
CACHE = ".gar_bench_cache"


def since_process_start() -> float:
    """Seconds since this process started (its start time in clock ticks
    since boot, against the boot-time clock)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Fixed build and kernel-cache directories inside the checkout (the
    port's own ``nvcc`` libraries land in ``stylerenderer_tpu_torch/_build``)."""
    base = os.path.join(root, CACHE)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m gar_bench", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code: int, msg: str) -> int:
    print(f"gar_bench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None, root: str | None = None, device=None, base: str = spec.HERE) -> int:
    """One run. ``device`` other than ``None`` skips the look for a card and
    runs there, and ``base`` is where configurations, traffic, limits,
    loops and metrics are found (the tests drive the CPU so)."""
    args = parse(argv)
    root = os.getcwd() if root is None else root
    bench = spec.benchmark(root)
    wl = spec.workload(bench, args.workload)
    cfg, traffic = spec.config(wl["config"], base), spec.traffic(wl["traffic"], base)
    limits = spec.limits(wl["name"], base)
    cache_dirs(root)
    import torch

    from gar_bench.compare import judge

    phases = {"imports": since_process_start()}
    if device is None:
        if not torch.cuda.is_available():
            return fail(2, "no CUDA card (torch.cuda.is_available() is False)")
        if torch.cuda.device_count() < wl["chips"]:
            return fail(2, f"{torch.cuda.device_count()} cards, the cell needs {wl['chips']}")
        device = torch.device("cuda", 0)
        t = time.perf_counter()
        torch.cuda.init()
        torch.empty(1, device=device)
        phases["cuda init"] = time.perf_counter() - t
    try:
        import stylerenderer_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(3, f"the port cannot be imported: {e}")
    torch.set_num_threads(2)
    client = spec.loop(traffic["kind"], base).Loop(cfg, traffic, args.seed, device)
    client.setup()
    setup_s = since_process_start()
    phases.update(client.phases)
    print("setup " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
          + f"; all {setup_s:.3f} s", file=sys.stderr, flush=True)

    result_metrics, breakdown, extra = {}, None, {}
    if args.trace:
        run = client.traced(args.seconds)
        for m in spec.cell_metrics(bench, "per_layer", wl["name"]):
            v = spec.metric(m["name"], base).read(run)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": run.trace.busy_s, "window_s": run.trace.window_s}
        breakdown = run.trace.breakdown()
    else:
        e2e = dict(client.window(args.seconds), setup_s=setup_s)
        for m in spec.cell_metrics(bench, "end_to_end", wl["name"]):
            result_metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    bad = forbidden_modules()
    if bad:
        return fail(4, f"loaded in the process after the window: {', '.join(bad)}")

    client.release()
    numbers = client.check()
    ok, shown = judge(numbers, limits)
    bad = forbidden_modules()
    if bad:
        return fail(4, f"loaded in the process: {', '.join(bad)}")
    result = {"correct": ok, "attempted": client.attempted, "failed": 0,
              "metrics": result_metrics,
              "device": dict({"platform": "gpu" if cuda else "cpu",
                              "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                              "count": wl["chips"], "memory_peak_bytes": peak,
                              "power_limit": power_limit() if cuda else "none"}, **extra)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = shown
    for k, v in shown.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
