"""Configuration system: Lua parameter files + parameter schema.

The reference's parameter files ARE Lua programs (src/lua-runtime-*.lua);
we keep that format verbatim by embedding a small Lua interpreter
(minilua.py) covering the language subset parameter files use, and
implement the ~95-parameter schema natively (schema.py).
"""

from .params import load_params, Params  # noqa: F401
