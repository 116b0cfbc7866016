"""The drivers of the cells' traffic, found by name.

A traffic file names its driver (``"driver": "train"``); the driver is the
module ``pb/drivers/<driver>.py``, which has

- ``TRAFFIC_KEYS``: the traffic file's keys it reads;
- ``CONFIG_KEYS``: the configuration file's keys it reads, and ``FIXED``,
  the keys it reads whose value it cannot change (a value it would not
  honour is refused, never dropped);
- ``run(cell, seed, seconds, traced, device, t0, faults=None, rank=0,
  world=1, control=None)``: the raw output of the timed path;
- ``check(cell, raw, seed, device, world=1)``: the numbers compared with the
  plain reference.

A new kind of traffic is a new file here. ``validate`` refuses a cell whose
files hold a key that its driver does not read, naming the key.
"""

from __future__ import annotations

import importlib
import re
from types import ModuleType

NAME = re.compile(r"^[a-z][a-z0-9_]{0,63}$")
# Keys that describe a file and are read by no driver.
TRAFFIC_ABOUT = frozenset({"driver", "about", "assumed", "limits"})
CONFIG_ABOUT = frozenset({"name", "source", "about", "reference", "assumed"})


def load(name: str) -> ModuleType:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad driver name {name!r}")
    try:
        return importlib.import_module(f"pb.drivers.{name}")
    except ModuleNotFoundError as exc:
        raise ValueError(f"no driver {name!r} (pb/drivers/{name}.py)") from exc


def validate(cell_name: str, traffic: dict, config: dict) -> ModuleType:
    """The cell's driver, once every key of its traffic and configuration is
    one the driver reads, and every fixed key holds the value it runs."""
    module = load(traffic.get("driver"))
    unread = sorted(set(traffic) - TRAFFIC_ABOUT - set(module.TRAFFIC_KEYS))
    if unread:
        raise ValueError(f"{cell_name}: traffic keys {unread} are read by no driver")
    unread = sorted(set(config) - CONFIG_ABOUT - set(module.CONFIG_KEYS))
    if unread:
        raise ValueError(f"{cell_name}: configuration keys {unread} are read by no driver")
    for key, value in module.FIXED.items():
        if config.get(key, value) != value:
            raise ValueError(f"{cell_name}: configuration key {key!r} = {config[key]!r}; "
                             f"the {traffic['driver']} driver runs only {value!r}")
    return module
