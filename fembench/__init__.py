"""The benchmark of mixedfem_tpu_torch: `python3 -m fembench.run --workload
NAME --seed N --seconds S --trace 0|1` from the root of a checkout
(README.md)."""

import importlib.util
import re
from types import ModuleType

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def module_at(root: str, folder: str, name: str) -> ModuleType:
    """The module fembench/<folder>/<name>.py of the checkout at `root`,
    loaded from its file: a configuration's judge or mesh recipe, or a
    metric's reader, found by the name that refers to it."""
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = f"{root}/fembench/{folder}/{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"fembench_{folder}_{re.sub('[.-]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
