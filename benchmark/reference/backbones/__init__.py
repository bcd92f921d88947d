"""Backbones of the reference beyond ``nets.PLANS``, one file each.

The module ``benchmark/reference/backbones/<name>.py`` serves the backbone
``<name>`` with two functions:

- ``build(cin, base) -> nn.Module``: plain torch, float32, NCHW in and the
  1/32 map out, ``final_channels`` set; its parameters are named as the
  published checkpoints' and the port's (``conv1.{0,1}``,
  ``layer{L}.{B}.convs.{i}``, ``...downsample.{0,1}``, ``...se.excite.{0,2}``),
  so one seeded state dict loads ``strict`` into it and into the measured
  program;
- ``macs(cin, h, w, base) -> (multiply_adds, channels, h, w)``: analytic,
  written from the published plan and never counted from the module; a
  grouped conv counts ``cin / groups`` input channels an output, an SE
  gate its two linears.

``nets`` and ``flops`` keep their two plans and ask :func:`lookup` for any
other name, while modules are built and counted in set-up.  So a
configuration brings a new backbone as one new file.  A module whose name
starts with ``_`` is a helper, not a backbone.
"""

from __future__ import annotations

import importlib
import pkgutil
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent


def names() -> List[str]:
    """Every backbone this package serves."""
    return sorted(m.name for m in pkgutil.iter_modules([str(HERE)])
                  if not m.name.startswith("_"))


def lookup(name: str) -> ModuleType:
    """The module serving the backbone ``name``; a name that no file serves
    fails with the file it looked for."""
    module = f"{__name__}.{name}"
    if name.isidentifier() and not name.startswith("_"):
        try:
            return importlib.import_module(module)
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
    raise FileNotFoundError(f"backbone {name!r} is not in nets.PLANS and has no file "
                            f"benchmark/reference/backbones/{name}.py")
