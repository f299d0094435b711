"""Load a Lua parameter file into a validated parameter namespace
(the analog of src/param.c + lua-runtime-config.lua's parse/bind).

Exposes the same execution environment the reference gives parameter
files: `args` (extra CLI arguments, 1-based with args[0] = filename),
linspace/logspace helpers (inclusive endpoint), and the `fastpm` helper
table (outerproduct, translation, linspace, logspace).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from . import minilua
from .minilua import LuaTable, lua_to_py, py_to_lua
from .schema import validate, SchemaError

__all__ = ["load_params", "Params", "SchemaError"]


def _linspace(a, e, N, endpoint=None, *_):
    """fastpm.linspace (lua-runtime-fastpm.lua:371-395): always includes
    the endpoint by default."""
    if endpoint is None:
        endpoint = True
    N = int(N)
    N1 = N - 1 if endpoint else N
    r = LuaTable()
    for i in range(1, N + 1):
        r.set(i, 1.0 * (e - a) * (i - 1) / N1 + a)
    if endpoint:
        r.set(N, float(e))
    return r


def _logspace(a, e, N, *_):
    r = _linspace(a, e, N)
    for i in range(1, int(N) + 1):
        r.set(i, 10.0 ** r.get(i))
    return r


def _outerproduct(a, b, c, *_):
    r = LuaTable()
    n = 0
    for i in range(1, a.length() + 1):
        for j in range(1, b.length() + 1):
            for k in range(1, c.length() + 1):
                n += 1
                r.set(n, LuaTable({1: a.get(i), 2: b.get(j), 3: c.get(k)}))
    return r


def _translation(dx, dy, dz, *_):
    return py_to_lua([[1, 0, 0, dx], [0, 1, 0, dy],
                      [0, 0, 1, dz], [0, 0, 0, 1]])


def _loglinspace(a, m, e, Nlog, Nlin, *_):
    """Nlog log steps a->m then Nlin linear steps m->e
    (lua-runtime-fastpm.lua:421-434)."""
    r = _logspace(math.log10(a), math.log10(m), Nlog + 1)
    s = _linspace(m, e, Nlin + 1)
    t = LuaTable()
    n = 0
    for i in range(1, r.length() + 1):
        n += 1
        t.set(n, r.get(i))
    for i in range(2, s.length() + 1):
        n += 1
        t.set(n, s.get(i))
    return t


def _blendspace(a, e, a1, a2, *_):
    r = LuaTable()
    i = 1
    x = a
    while x < e:
        r.set(i, x)
        dlna = (1.0 / a1 ** 2 + (x / a2) ** 2) ** -0.5
        x = math.exp(math.log(x) + dlna)
        i += 1
    r.set(i, float(e))
    return r


class Params:
    """Validated parameter namespace with attribute access."""

    def __init__(self, ns: Dict[str, Any], source: str = "",
                 filename: str = ""):
        self._ns = ns
        self.source = source       # full file text, for provenance attrs
        self.filename = filename

    def __getattr__(self, name):
        try:
            return self._ns[name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name):
        return self._ns[name]

    def get(self, name, default=None):
        return self._ns.get(name, default)

    def asdict(self):
        return dict(self._ns)


def load_params(filename: str, argv: Sequence[str] = (),
                runmain: bool = False) -> Params:
    """Execute the Lua parameter file and validate against the schema."""
    with open(filename) as f:
        source = f.read()
    return load_params_from_string(source, argv, filename=filename,
                                   cwd=os.path.dirname(os.path.abspath(filename)),
                                   runmain=runmain)


def load_params_from_string(source: str, argv: Sequence[str] = (),
                            filename: str = "<string>",
                            cwd: str = ".",
                            runmain: bool = False) -> Params:
    fastpm_tbl = LuaTable({
        "linspace": _linspace,
        "logspace": _logspace,
        "loglinspace": _loglinspace,
        "blendspace": _blendspace,
        "outerproduct": _outerproduct,
        "translation": _translation,
    })
    args = LuaTable({0: filename})
    for i, a in enumerate(argv):
        args.set(i + 1, a)
    g = minilua.run(source, {
        "fastpm": fastpm_tbl,
        "linspace": _linspace,
        "logspace": _logspace,
        "loglinspace": _loglinspace,
        "args": args,
    })
    # if the file defines a main function, optionally execute it, and
    # always prune it from the namespace (lua-runtime-config.lua:708-716)
    main = g.pop("main", None)
    if main is not None and runmain:
        minilua.call_function(main, (), g)
    # collect plain-value globals (skip stdlib/functions)
    raw = {}
    for k, v in g.items():
        if callable(v) or isinstance(v, minilua.LuaFunction):
            continue
        if k in ("math", "string", "table", "fastpm", "args"):
            continue
        raw[k] = lua_to_py(v)
    ns = validate(raw)
    # resolve relative file paths against the param file's directory
    for key in ("read_powerspectrum", "read_lineark", "read_whitenoisek",
                "read_grafic", "read_runpbic", "read_powerspectrum_ncdm",
                "read_lineark_ncdm", "read_linear_growth_rate",
                "read_linear_growth_rate_ncdm", "ncdm_transfer_nu_file"):
        if ns.get(key) and not os.path.isabs(ns[key]):
            ns[key] = os.path.join(cwd, ns[key])
    return Params(ns, source=source, filename=filename)
