"""IO subsystem: bigfile containers and snapshots, byte-compatible with
the reference (libfastpmio/io.c + depends/bigfile)."""

from .bigfile import BigFile, BigBlock  # noqa: F401
