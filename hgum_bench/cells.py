"""Find a cell's files by name: ``workloads/<cell>.json``, the
configuration ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json``, the plane driver ``planes/<plane>.py``, one
file per metric, ``end_to_end/<name>.py`` and ``metrics/<name>.py``, and
the configuration's family ``families/<family>.py`` where it names one.
Adding a cell, a configuration, a mix, a metric or a family adds a file;
no file that is there changes."""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict

from . import flops, traffic
from .reference import model, weights

ROOT = Path(__file__).resolve().parent
#: what a family provides, with the default family's signatures
FAMILY_FUNCTIONS = ("dims", "spec", "forward", "sequence_flops", "program_overrides")


def _json(path: Path, name: str) -> dict:
    obj = json.loads(path.read_text())
    if obj.get("name") != name:
        raise ValueError(f"{path} names itself {obj.get('name')!r}, not {name!r}")
    return obj


def load_module(path: Path) -> ModuleType:
    """A metric, plane or family file as a module of its own."""
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
    #: the configuration's reference family (``load_family``)
    family: object

    @property
    def name(self) -> str:
        return self.workload["name"]


def default_family() -> SimpleNamespace:
    """The family of a configuration that names none: the dense GQA and
    top-k MoE decoder of ``reference/model.py``, as the functions that ran
    before families existed."""
    return SimpleNamespace(dims=weights.dims, spec=weights.spec, forward=model.forward,
                           sequence_flops=flops.sequence_flops,
                           program_overrides=weights.decoder_overrides)


def load_family(config: dict, root: Path = ROOT):
    """The benchmark's reference family of a configuration: the module
    ``families/<name>.py`` that its key ``"family"`` names, or the default.

    A family is the reference's side of a model: ``dims(config)``, the
    short names the harness and the check read (at least ``V``, ``E``,
    ``k`` and ``cf``); ``spec(config)``, every weight as (name, shape,
    dtype, std), named as the program's ``named_parameters``;
    ``forward(W, config, tokens, out_from, groups=None, quant=None,
    block=128)``, the float32 logits; ``sequence_flops(config,
    prompt_len, generated)``; and ``program_overrides(config)``, the
    keyword arguments that turn the registry entry of ``arch`` into the
    program's ``ModelConfig``.  The word means this, not the program's
    ``ModelConfig.family`` ("lm", "encdec", "vlm").  A family imports
    nothing of the program and nothing of JAX."""
    name = config.get("family")
    if name is None:
        return default_family()
    mod = load_module(root / "families" / f"{name}.py")
    missing = [f for f in FAMILY_FUNCTIONS if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"family {name!r} lacks {missing}")
    return mod


def load(name: str, root: Path = ROOT) -> Cell:
    wl = _json(root / "workloads" / f"{name}.json", name)
    config = _json(root / "configs" / f"{wl['config']}.json", wl["config"])
    return Cell(
        workload=wl,
        config=config,
        mix=traffic.load(wl["traffic"], root),
        plane=load_module(root / "planes" / f"{wl['plane']}.py"),
        end_to_end={m: load_module(root / "end_to_end" / f"{m}.py") for m in wl["end_to_end"]},
        per_layer={m: load_module(root / "metrics" / f"{m}.py") for m in wl["per_layer"]},
        family=load_family(config, root),
    )
