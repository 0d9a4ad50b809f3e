"""A cell of ``BENCHMARK.json``: its configuration, traffic mix and limits.

Each piece is a file found by its name in ``BENCHMARK.json``: the cell
(``workloads[].name``) names a configuration (``configs[].file``) and a
traffic mix (``traffic/<traffic>.json``); the correctness limits are in
``limits/<workload>.json``. The metrics that apply to a cell are the
entries of ``end_to_end`` and ``per_layer`` whose ``workloads`` list holds
it, or that have no such list.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

PACKAGE = Path(__file__).resolve().parent
CHECKOUT = PACKAGE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, benchmark: Path = CHECKOUT / "BENCHMARK.json"
              ) -> Cell:
    """The cell named ``workload``; raises ``KeyError`` for an unknown one."""
    spec = read_json(benchmark)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark}; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config_name=w["config"],
        traffic_name=w["traffic"],
        config=read_json(CHECKOUT / configs[w["config"]]["file"]),
        traffic=read_json(PACKAGE / "traffic" / f"{w['traffic']}.json"),
        limits=read_json(PACKAGE / "limits" / f"{workload}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)],
    )
