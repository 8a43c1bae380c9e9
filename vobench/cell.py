"""A cell of ``BENCHMARK.json`` and the files it names, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``, the traffic's
driver ``drivers/<driver>.py``, ``limits/<cell>.json`` and, for each
metric, ``metrics/<metric>.py``.  Adding a configuration, a traffic mix, a
driver, a metric or a cell adds files and entries and edits none."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict  # each compared number's limit
    end_to_end: list  # the metric entries this cell reports, trace 0
    per_layer: list  # and with trace 1
    files: Path = HERE  # the folder its files were found in


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Optional[Path] = None,
         files: Optional[Path] = None) -> Cell:
    """Cell ``name`` of ``BENCHMARK.json`` in ``root`` (the working
    directory by default), its files under ``files`` (this folder by
    default); raises KeyError for a cell it does not list."""
    root = Path.cwd() if root is None else Path(root)
    files = HERE if files is None else Path(files)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(files / "configs" / f"{w['config']}.json"),
        traffic=_json(files / "traffic" / f"{w['traffic']}.json"),
        limits=_json(files / "limits" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        files=files)


def _module(kind: str, name: str, files: Optional[Path]):
    path = (HERE if files is None else Path(files)) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"vobench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, files: Optional[Path] = None):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    return _module("metrics", metric, files).read


def driver(name: str, files: Optional[Path] = None):
    """The ``Driver`` class of ``drivers/<name>.py``."""
    return _module("drivers", name, files).Driver


def pipeline_config(spec: dict):
    """The program's ``PipelineConfig`` from the configuration file's
    ``pipeline`` group, every field given; an unknown or missing key
    raises."""
    from monocular_visual_odometry_va4mr_torch.core import config as cfgmod

    def build(cls, d):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        if set(d) != set(fields):
            raise ValueError(f"{cls.__name__}: keys {sorted(d)} are not its "
                             f"fields {sorted(fields)}")
        kw = {}
        for k, v in d.items():
            default = getattr(cls(), k)
            if dataclasses.is_dataclass(default):
                kw[k] = build(type(default), v)
            elif isinstance(default, tuple):
                kw[k] = tuple(v)
            else:
                kw[k] = v
        return cls(**kw)

    return build(cfgmod.PipelineConfig, spec)
