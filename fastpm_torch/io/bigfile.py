"""Pure-Python bigfile container, byte-compatible with the reference's
depends/bigfile format (the format nbodykit and MP-Gadget tooling read):

- a "file" is a directory; a "block" is a subdirectory (names may nest,
  e.g. "1/Position")
- block dir contains:
    header    text: "DTYPE: <e><k><w>\\nNMEMB: n\\nNFILE: n\\n" then per
              data file "%06X: <fsize> : <sysv checksum> : <folded>\\n"
    attr-v2   one line per attribute:
              "name dtype nmemb <hex bytes> #HUMANE [ <textual> ]\\n"
    %06X      raw little-endian binary data files
- checksums are SysV byte sums folded to 16 bits in the header's last
  column.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

__all__ = ["BigFile", "BigBlock"]


ITEMS_PER_FILE = 32 * 1024 * 1024   # io.c:353 items_per_file
CHUNK_ROWS = 8 * 1024 * 1024        # bounded serialize buffer per write


def auto_nfile(nrows: int) -> int:
    """The reference's file fan-out rule: ceil(rows / 32M items), at
    least 1 (io.c:473-479). Bounds per-file size so large columns are
    split the same way the reference splits them for staggered
    writers."""
    return max(1, (nrows + ITEMS_PER_FILE - 1) // ITEMS_PER_FILE)


def _normalize_dtype(dtype) -> str:
    """'f4' -> '<f4' etc.; endianness explicit, always little on our
    targets (bigfile.c:_dtype_normalize)."""
    s = np.dtype(dtype).str
    if s[0] == "=" or s[0] == "|":
        s = "<" + s[1:]
    return s


def _sysv_fold(s: int) -> int:
    r = (s & 0xffff) + ((s & 0xffffffff) >> 16)
    return (r & 0xffff) + (r >> 16)


def _sysv_sum(data: bytes) -> int:
    return int(np.frombuffer(data, dtype=np.uint8).sum(dtype=np.uint64)
               & 0xffffffff)


def _format_attr_value(dtype: str, data: bytes, nmemb: int) -> str:
    """The #HUMANE textual comment (bigfile.c:1586-1613); informational
    only -- readers parse the hex."""
    if len(data) > 128:
        return "... (Too Long) "
    dt = np.dtype(dtype)
    if dt.kind in "S" or dtype.endswith("a1") or dt.itemsize == 1 and dt.kind == "S":
        try:
            return data.split(b"\0")[0].decode("ascii", "replace")
        except Exception:
            return ""
    arr = np.frombuffer(data, dtype=dt)
    out = []
    for v in arr:
        if dt.kind == "f":
            out.append("%g" % v)
        else:
            out.append(str(int(v)))
    return " ".join(out)


class BigAttrs:
    """Typed attribute set backed by the attr-v2 file."""

    def __init__(self, path: str):
        self.path = path
        # name -> (dtype_str, nmemb, bytes)
        self._attrs: Dict[str, Tuple[str, int, bytes]] = {}
        self._load()

    def _load(self):
        fn = os.path.join(self.path, "attr-v2")
        if not os.path.exists(fn):
            return
        with open(fn) as f:
            for line in f:
                parts = line.split(" ", 4)
                if len(parts) < 4:
                    continue
                name, dtype, nmemb, rawhex = parts[0], parts[1], int(parts[2]), parts[3]
                self._attrs[name] = (dtype, nmemb, bytes.fromhex(rawhex))

    def _save(self):
        fn = os.path.join(self.path, "attr-v2")
        with open(fn, "w") as f:
            for name, (dtype, nmemb, data) in self._attrs.items():
                textual = _format_attr_value(dtype, data, nmemb)
                f.write("%s %s %d %s #HUMANE [ %s ]\n"
                        % (name, dtype, nmemb, data.hex().upper(), textual))

    def set(self, name: str, value, dtype=None):
        if isinstance(value, str):
            data = value.encode()
            self._attrs[name] = ("<S1", len(data), data)
        else:
            arr = np.atleast_1d(np.asarray(
                value, dtype=np.dtype(dtype) if dtype else None))
            dt = _normalize_dtype(arr.dtype)
            arr = arr.astype(dt)
            self._attrs[name] = (dt, arr.size, arr.tobytes())
        self._save()

    def get(self, name: str):
        dtype, nmemb, data = self._attrs[name]
        if dtype in ("<S1", "S1", "a1", "<a1"):
            return data.split(b"\0")[0].decode()
        arr = np.frombuffer(data, dtype=np.dtype(dtype.replace("a", "S")))
        if nmemb == 1:
            return arr[0]
        return arr.copy()

    def __contains__(self, name):
        return name in self._attrs

    def keys(self):
        return list(self._attrs.keys())

    def asdict(self):
        return {k: self.get(k) for k in self._attrs}


class BigBlock:
    def __init__(self, path: str):
        self.path = path
        self.attrs = BigAttrs(path)
        self.dtype: Optional[str] = None
        self.nmemb = 1
        self.Nfile = 0
        self.fsize: List[int] = []
        self._load_header()

    # ---- header ----

    def _load_header(self):
        fn = os.path.join(self.path, "header")
        if not os.path.exists(fn):
            self._checksums = []
            return
        with open(fn) as f:
            lines = f.read().split("\n")
        kv = {}
        files = {}
        sums = {}
        for line in lines:
            if not line.strip():
                continue
            key, _, rest = line.partition(":")
            key = key.strip()
            if key in ("DTYPE", "NMEMB", "NFILE"):
                kv[key] = rest.strip()
            else:
                try:
                    fid = int(key, 16)
                except ValueError:
                    continue
                parts = rest.split(":")
                files[fid] = int(parts[0].strip())
                sums[fid] = int(parts[1].strip()) if len(parts) > 1 else 0
        self.dtype = kv.get("DTYPE")
        self.nmemb = int(kv.get("NMEMB", 1))
        self.Nfile = int(kv.get("NFILE", 0))
        self.fsize = [files.get(i, 0) for i in range(self.Nfile)]
        self._checksums = [sums.get(i, 0) for i in range(self.Nfile)]

    def _write_header(self, checksums):
        with open(os.path.join(self.path, "header"), "w") as f:
            f.write("DTYPE: %s\n" % self.dtype)
            f.write("NMEMB: %d\n" % self.nmemb)
            f.write("NFILE: %d\n" % self.Nfile)
            for i in range(self.Nfile):
                s = checksums[i]
                f.write("%06X: %d : %u : %u\n"
                        % (i, self.fsize[i], s, _sysv_fold(s)))

    # ---- data ----

    @property
    def size(self) -> int:
        return sum(self.fsize)

    def write_all(self, data: np.ndarray, Nfile: Optional[int] = 1):
        """Write the whole dataset (rows x nmemb), splitting evenly over
        Nfile data files. Nfile=None applies the reference sizing rule
        (ceil(rows / 32M items), io.c:473-479), the aggregated-IO
        throttle of libfastpmio (io.c:349-360): large columns fan out
        over many files instead of one monolith. Each file is streamed
        in bounded chunks so the serialized buffer never exceeds
        ~CHUNK_ROWS rows."""
        data = np.ascontiguousarray(data)
        if data.ndim == 1:
            data = data[:, None]
        nrows, nmemb = data.shape
        if Nfile is None:
            Nfile = auto_nfile(nrows)
        self.dtype = _normalize_dtype(data.dtype)
        data = data.astype(self.dtype)
        self.nmemb = nmemb
        self.Nfile = max(1, Nfile)
        per = [nrows * (i + 1) // self.Nfile - nrows * i // self.Nfile
               for i in range(self.Nfile)]
        self.fsize = per
        checksums = []
        start = 0
        for i, n in enumerate(per):
            bytesum = 0  # unmasked; == _sysv_sum(whole) after the mask
            with open(os.path.join(self.path, "%06X" % i), "wb") as f:
                for j0 in range(0, n, CHUNK_ROWS):
                    raw = data[start + j0:
                               start + min(j0 + CHUNK_ROWS, n)].tobytes()
                    f.write(raw)
                    bytesum += int(np.frombuffer(
                        raw, dtype=np.uint8).sum(dtype=np.uint64))
            checksums.append(bytesum & 0xffffffff)
            start += n
        self._checksums = checksums
        self._write_header(checksums)

    def append(self, data: np.ndarray):
        """Append rows as a new data file (bigfile allows per-file sizes;
        used for growing lightcone datasets)."""
        data = np.ascontiguousarray(data)
        if data.ndim == 1:
            data = data[:, None]
        if self.dtype is None:
            return self.write_all(data)
        data = data.astype(np.dtype(self.dtype))
        raw = data.tobytes()
        with open(os.path.join(self.path, "%06X" % self.Nfile), "wb") as f:
            f.write(raw)
        self.fsize.append(data.shape[0])
        self._checksums.append(_sysv_sum(raw))
        self.Nfile += 1
        self._write_header(self._checksums)

    def read_all(self) -> np.ndarray:
        out = []
        for i in range(self.Nfile):
            fn = os.path.join(self.path, "%06X" % i)
            with open(fn, "rb") as f:
                raw = f.read()
            out.append(np.frombuffer(raw, dtype=np.dtype(self.dtype)))
        if not out:
            return np.empty((0, self.nmemb), dtype=self.dtype or "f8")
        arr = np.concatenate(out)
        if self.nmemb > 1:
            arr = arr.reshape(-1, self.nmemb)
        return arr.copy()


class BigFile:
    """A bigfile container directory."""

    def __init__(self, path: str, create: bool = False):
        self.path = path
        if create:
            os.makedirs(path, exist_ok=True)
        if not os.path.isdir(path):
            raise FileNotFoundError(path)

    def create_block(self, name: str, data: Optional[np.ndarray] = None,
                     Nfile: Optional[int] = 1) -> BigBlock:
        bpath = os.path.join(self.path, name)
        os.makedirs(bpath, exist_ok=True)
        block = BigBlock(bpath)
        if data is not None:
            block.write_all(np.asarray(data), Nfile=Nfile)
        else:
            # attribute-only block (like the reference's Header)
            block.dtype = "<i8"
            block.nmemb = 1
            block.Nfile = 0
            block.fsize = []
            block._write_header([])
        return block

    def open_block(self, name: str) -> BigBlock:
        bpath = os.path.join(self.path, name)
        if not os.path.isdir(bpath):
            raise FileNotFoundError(f"no block {name} in {self.path}")
        return BigBlock(bpath)

    def has_block(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.path, name, "header"))

    def list_blocks(self) -> List[str]:
        out = []
        for root, dirs, files in os.walk(self.path):
            if "header" in files:
                rel = os.path.relpath(root, self.path)
                out.append(rel)
        return sorted(out)
