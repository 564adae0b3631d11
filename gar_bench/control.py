"""Readings of the check's control and planted faults at a cell's own size,
which set the upper end of each limit (the benchmark's own runs never run
this):

    python3 -m gar_bench.control --workload NAME --seeds 1,2,3 [--fault half_batch | --program]

The control puts the reference in the program's place, computed one step
below each precision the configuration states (``reference/lowp.py``), and
compares it with the reference as a run compares the program; a fault puts
the reference in the program's place with the fault planted. Each loop
(``loops/<kind>.py::control_readings``) says how for its kind: for
generation, the same number of sampled images of a window of
``--batches`` batches; for inversion, the first three steps, and the fault
``half_batch``. ``--program`` reads the program instead, as a run does
(set-up, a window of ``--seconds``, the check), for the lower end of each
limit; every seed in one process. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from gar_bench import spec


def readings(wl: dict, seed: int, fault: str | None, batches: int, base: str = spec.HERE,
             device=None) -> dict:
    cfg, traffic = spec.config(wl["config"], base), spec.traffic(wl["traffic"], base)
    loop = spec.loop(traffic["kind"], base)
    client = loop.Loop(cfg, traffic, seed, device or torch.device("cuda", 0))
    client.inputs()
    return loop.control_readings(client, traffic, cfg, seed, fault, batches)


def program_readings(wl: dict, seed: int, seconds: float, base: str = spec.HERE,
                     device=None) -> dict:
    cfg, traffic = spec.config(wl["config"], base), spec.traffic(wl["traffic"], base)
    client = spec.loop(traffic["kind"], base).Loop(cfg, traffic, seed,
                                                   device or torch.device("cuda", 0))
    client.setup()
    client.window(seconds)
    client.release()
    out = client.check()
    del client
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--fault", default=None)
    p.add_argument("--program", action="store_true",
                   help="read the program (a run's set-up, window and check) instead")
    p.add_argument("--seconds", type=float, default=3.0, help="the window of --program")
    p.add_argument("--batches", type=int, default=250,
                   help="batches of the nominal window the generation sample is drawn from")
    args = p.parse_args(argv)
    wl = spec.workload(spec.benchmark(os.getcwd()), args.workload)
    for s in args.seeds.split(","):
        if args.program:
            out, what = program_readings(wl, int(s), args.seconds), "program"
        else:
            out, what = readings(wl, int(s), args.fault, args.batches), args.fault or "control"
        print(json.dumps({"workload": wl["name"], "seed": int(s), "reading": what, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
