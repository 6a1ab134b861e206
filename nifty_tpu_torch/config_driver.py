"""INI-file driven inference configuration (counterpart of
:mod:`nifty_tpu.config_driver`): ConfigParser sections mapped onto
:func:`nifty_tpu_torch.optimize_kl` arguments, with

- section inheritance via a ``base`` key,
- run-length schedule syntax ``"2*5,3*2"`` → per-iteration callables,
- ``*section`` value references instantiated through user-supplied
  builder functions or dotted-path imports (``module.sub:function``),
- round-tripping back to a file.
"""

from __future__ import annotations

import configparser
import importlib
from typing import Any, Callable, Mapping, Optional


def parse_value(v: str):
    """str → int/float/bool/None/str with run-length schedule support."""
    s = v.strip()
    if "," in s or "*" in s:
        try:
            return _parse_schedule(s)
        except ValueError:
            pass
    low = s.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("none", ""):
        return None
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            continue
    return s


def _parse_schedule(s: str):
    """``"2*5,3*2"`` → [5, 5, 2, 2, 2] (value-per-iteration list); the
    values are numbers, so anything else falls back to a plain string."""
    out = []
    for part in s.split(","):
        part = part.strip()
        if "*" in part:
            n, val = part.split("*", 1)
            out.extend([_num(val)] * int(n))
        else:
            out.append(_num(part))
    return out


def _num(s: str):
    s = s.strip()
    try:
        return int(s)
    except ValueError:
        return float(s)


def _schedule_to_callable(lst):
    def at(i):
        return lst[min(i, len(lst) - 1)]

    return at


class OptimizeKLConfig:
    """Build :func:`nifty_tpu_torch.optimize_kl` arguments from config sections.

    Parameters
    ----------
    sections : mapping of str -> mapping
        Raw (string-valued) config sections; must contain ``optimize_kl``.
    builders : mapping of str -> callable, optional
        Functions instantiating ``*section`` references: called with the
        section's parsed key/values.  A section may instead name its own
        constructor under the ``custom_function`` key as a dotted path
        ``module.sub:function``.
    """

    def __init__(self, sections: Mapping[str, Mapping[str, str]],
                 builders: Optional[Mapping[str, Callable]] = None):
        self.sections = {k: dict(v) for k, v in sections.items()}
        self.builders = dict(builders or {})
        if "optimize_kl" not in self.sections:
            raise ValueError("config must contain an `optimize_kl` section")

    @classmethod
    def from_file(cls, fname, builders=None) -> "OptimizeKLConfig":
        cp = configparser.ConfigParser()
        cp.optionxform = str  # preserve case
        with open(fname) as f:
            cp.read_file(f)
        return cls({s: dict(cp[s]) for s in cp.sections()}, builders)

    def to_file(self, fname):
        cp = configparser.ConfigParser()
        cp.optionxform = str
        for name, sec in self.sections.items():
            cp[name] = {k: str(v) for k, v in sec.items()}
        with open(fname, "w") as f:
            cp.write(f)

    def _resolve_section(self, name: str) -> dict:
        sec = dict(self.sections[name])
        base = sec.pop("base", None)
        if base is not None:
            merged = self._resolve_section(base.strip())
            merged.update(sec)
            sec = merged
        return sec

    def _instantiate(self, name: str):
        sec = self._resolve_section(name)
        kwargs = {k: self._value(k, v) for k, v in sec.items()}
        fn_path = kwargs.pop("custom_function", None)
        if fn_path is not None:
            mod, _, fn = str(fn_path).rpartition(":")
            builder = getattr(importlib.import_module(mod), fn)
        elif name in self.builders:
            builder = self.builders[name]
        else:
            # no builder: return the parsed dict itself
            return kwargs
        return builder(**kwargs)

    def _value(self, key: str, v: Any):
        if isinstance(v, str) and v.strip().startswith("*"):
            return self._instantiate(v.strip()[1:])
        out = parse_value(v) if isinstance(v, str) else v
        if isinstance(out, list):
            return _schedule_to_callable(out)
        return out

    def instantiate(self) -> dict:
        """Resolved keyword arguments for :func:`nifty_tpu_torch.optimize_kl`."""
        sec = self._resolve_section("optimize_kl")
        return {k: self._value(k, v) for k, v in sec.items()}

    def optimize_kl(self, likelihood=None, position_or_samples=None, *,
                    key=None, **overrides):
        """Run :func:`nifty_tpu_torch.optimize_kl` with the configured args.
        Without ``key`` the run's key is the int seed ``seed`` (default 42),
        an int being a key of the port."""
        from .optimize_kl import optimize_kl as _okl

        kwargs = self.instantiate()
        if likelihood is None:
            likelihood = kwargs.pop("likelihood")
        else:
            kwargs.pop("likelihood", None)
        kwargs.update(overrides)
        if key is None:
            key = int(kwargs.pop("seed", 42))
        else:
            kwargs.pop("seed", None)
        return _okl(likelihood, position_or_samples, key=key, **kwargs)

    def __getitem__(self, name):
        return self._resolve_section(name)


__all__ = ["OptimizeKLConfig", "parse_value"]
