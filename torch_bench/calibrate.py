"""Readings that the correctness limits are set from (not run by the
benchmark's own runs).

    python3 -m torch_bench.calibrate --workload <name> --seeds 1,2,3 \
        --modes sound,control,half_batch,unchanged,program_tf32

For each seed and mode, in one process: the mode's first rounds, the plain
f32 reference's (following the mode's selections) and every number that
``run.py`` compares between the two:

- ``sound``: the program as the configuration states it;
- ``control``: the reference in the configuration's control precision
  (``config["control"]``) put in the program's place (``faults.control``);
  ``control:<precision>`` the same in another precision of
  ``reference/precision.py``;
- ``program_tf32``: the program with TF32 on (an f32 configuration's own
  lower-precision path);
- a name of ``faults.PLANTS``: the program with that fault planted
  underneath.

Prints one JSON line a (seed, mode), and with ``--out`` appends them there;
``--per-client`` adds round 1's gaps client by client (:func:`client_gaps`),
and a defense that selects adds its ties (:func:`tie_readings`).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from torch_bench import faults, federation, program
from torch_bench.cell import load_cell
from torch_bench.reference.defenses import krum
from torch_bench.run import FIRST_ROUNDS, compare, first_rounds, reference


def program_readings(cell, fed, device, plant=None, tf32=False):
    program.apply_precision_flags(cell.config)
    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    engine = program.build_engine(cell.config, cell.traffic, fed)
    if plant is not None:
        plant(engine, fed)
    try:
        return first_rounds(engine, fed.theta0.clone(),
                            federation.round_generator(fed, device),
                            FIRST_ROUNDS,
                            cell.traffic["defense"].get("selection"))
    finally:
        program.apply_precision_flags(cell.config)


def readings(mode, cell, fed, device):
    if mode == "sound":
        return program_readings(cell, fed, device)
    if mode == "program_tf32":
        return program_readings(cell, fed, device, tf32=True)
    if mode.split(":")[0] == "control":
        precision = mode.split(":")[1] if ":" in mode else None
        return program_readings(cell, fed, device, faults.control(
            cell.config, cell.traffic, precision))
    if mode in faults.PLANTS:
        return program_readings(cell, fed, device, faults.PLANTS[mode])
    raise ValueError(f"unknown mode {mode!r}")


def quantiles(x: torch.Tensor):
    x = x.double().sort().values.cpu()
    q = lambda p: float(x[min(len(x) - 1, int(p * len(x)))])
    return {"min": float(x[0]), "p10": q(0.1), "p25": q(0.25),
            "median": q(0.5), "p75": q(0.75), "p90": q(0.9),
            "max": float(x[-1])}


def client_gaps(got, ref, leaves, device):
    """Round 1's trained rows, client by client: for each client and leaf
    ``|a_l - b_l| / max(|b_l|, the client's median leaf)`` (``a``, ``b``
    the program's and the reference's change of the row); the quantiles
    over clients of each client's worst leaf (``worst``), of its median
    leaf (``median_leaf``) and of its whole row's relative gap (``row``),
    and the median leaf of the all-client gap (``all_median_leaf``)."""
    p0 = got.thetas[0].to(device)
    a = got.trained[0].to(device) - p0
    b = ref.trained[0].to(device) - p0
    d, w, lo = [], [], 0
    for _, shape in leaves:
        n = math.prod(shape)
        d.append((a[:, lo:lo + n] - b[:, lo:lo + n]).double().norm(dim=1))
        w.append(b[:, lo:lo + n].double().norm(dim=1))
        lo += n
    d, w = torch.stack(d, 1), torch.stack(w, 1)
    g = d / torch.maximum(w, w.median(dim=1, keepdim=True).values)
    dl, wl = d.square().sum(0).sqrt(), w.square().sum(0).sqrt()
    gl = dl / torch.maximum(wl, wl.median())
    return {"worst": quantiles(g.max(dim=1).values),
            "median_leaf": quantiles(g.median(dim=1).values),
            "row": quantiles(d.square().sum(1).sqrt()
                             / w.square().sum(1).sqrt()),
            "all_median_leaf": float(gl.median()),
            "all_by_leaf": [float(v) for v in gl]}


def tie_readings(got, cell, device):
    """Each round's selection on the program's attacked rows, as the
    reference scores them (Krum's, or Bulyan's first): the lowest score,
    the gap to the next one and the tie margin, relative to the lowest,
    and whether the program chose the reference's lowest row."""
    f = int(cell.traffic["defense"]["config"].get("num_malicious", 1))
    out = []
    for attacked, chosen in zip(got.attacked, got.selections):
        rows = attacked.to(device)
        exact = krum.distances(rows)
        sc = krum.nearest_sum(exact, f)
        low = sc.sort().values
        tie = krum.margin(exact, krum.f32_distances(rows), f)
        best = int(torch.argmin(sc))
        out.append({"next_gap": float((low[1] - low[0]) / low[0]),
                    "margin": tie / float(low[0]),
                    "program_took_lowest": bool(chosen[best] > 0)})
    return out


def calibrate(cell, seeds, modes, device="cuda", per_client=False):
    for seed in seeds:
        program.apply_precision_flags(cell.config)
        fed = federation.make_federation(cell.config, cell.traffic, seed,
                                         device)
        for mode in modes:
            t = time.perf_counter()
            got = readings(mode, cell, fed, device)
            t_ref = time.perf_counter()
            ref = reference(cell, fed, got, device)
            numbers = compare(cell, fed, got, device, ref)
            extra = ({"clients": client_gaps(got, ref, cell.config["leaves"],
                                             device)}
                     if per_client else {})
            if got.selections and got.selections[0] is not None:
                extra["ties"] = tie_readings(got, cell, device)
            yield {"workload": cell.name, "seed": seed, "mode": mode,
                   "numbers": numbers, "losses": got.losses, **extra,
                   "seconds": t_ref - t,
                   "reference_seconds": time.perf_counter() - t_ref}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="sound,control")
    ap.add_argument("--out")
    ap.add_argument("--per-client", action="store_true")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in calibrate(cell, seeds, args.modes.split(","),
                          per_client=args.per_client):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
