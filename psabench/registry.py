"""Finds a cell, configuration, traffic mix, driver, entry and metric by
name, each in a file of its own:

    cells/<cell>.json        {"config", "traffic", "chips", "why"}
    configs/<config>.json    the deployment: its entry and its scoring
    traffic/<traffic>.json   the mix's parameters, with the driver's "kind"
    traffic/<kind>.py        the driver that runs a mix of that kind
    entries/<entry>.py       how a configuration's entry is called
    metrics/<file>.py        one metric (its NAME, or the file's name)

A later cell, mix or metric is a new file here; no file that is already
here needs an edit.
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
MODULE = re.compile(r"[A-Za-z_][A-Za-z0-9_]{0,63}")


def _json(folder: str, name: str) -> dict:
    if not NAME.fullmatch(name):
        raise ValueError(f"bad {folder} name {name!r}")
    path = ROOT / folder / f"{name}.json"
    if not path.is_file():
        known = sorted(p.stem for p in (ROOT / folder).glob("*.json"))
        raise KeyError(f"no {folder} named {name!r} (known: {known})")
    return dict(json.loads(path.read_text()), name=name)


def cell(name: str) -> dict:
    return _json("cells", name)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def _module(package: str, name: str):
    if not MODULE.fullmatch(name):
        raise ValueError(f"bad {package} module name {name!r}")
    return importlib.import_module(f"psabench.{package}.{name}")


def driver(kind: str):
    """The traffic driver `traffic/<kind>.py`."""
    return _module("traffic", kind)


def entry(name: str):
    """The entry adapter `entries/<name>.py`."""
    return _module("entries", name)


def metric_name(module) -> str:
    return getattr(module, "NAME", module.__name__.rsplit(".", 1)[-1])


def metrics() -> list:
    """Every metric module under metrics/, in file-name order."""
    return [_module("metrics", p.stem)
            for p in sorted((ROOT / "metrics").glob("*.py"))
            if p.stem != "__init__"]


def cells() -> list:
    return sorted(p.stem for p in (ROOT / "cells").glob("*.json"))
