"""Find a cell's files by name: ``workloads/<cell>.json``, the
configuration ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json``, the plane driver ``planes/<plane>.py`` and one
file per metric, ``end_to_end/<name>.py`` and ``metrics/<name>.py``.
Adding a cell, a configuration, a mix or a metric adds a file; no file
that is there changes."""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict

from . import traffic

ROOT = Path(__file__).resolve().parent


def _json(path: Path, name: str) -> dict:
    obj = json.loads(path.read_text())
    if obj.get("name") != name:
        raise ValueError(f"{path} names itself {obj.get('name')!r}, not {name!r}")
    return obj


def load_module(path: Path) -> ModuleType:
    """A metric or plane file as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(path)
    mod_name = "hgum_bench_" + re.sub(r"\W", "_", str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    workload: dict
    config: dict
    mix: dict
    plane: ModuleType
    end_to_end: Dict[str, ModuleType]
    per_layer: Dict[str, ModuleType]

    @property
    def name(self) -> str:
        return self.workload["name"]


def load(name: str, root: Path = ROOT) -> Cell:
    wl = _json(root / "workloads" / f"{name}.json", name)
    return Cell(
        workload=wl,
        config=_json(root / "configs" / f"{wl['config']}.json", wl["config"]),
        mix=traffic.load(wl["traffic"], root),
        plane=load_module(root / "planes" / f"{wl['plane']}.py"),
        end_to_end={m: load_module(root / "end_to_end" / f"{m}.py") for m in wl["end_to_end"]},
        per_layer={m: load_module(root / "metrics" / f"{m}.py") for m in wl["per_layer"]},
    )
