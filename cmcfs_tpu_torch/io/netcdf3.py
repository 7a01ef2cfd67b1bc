"""Minimal from-scratch NetCDF-3 (classic / 64-bit-offset) writer and reader.

The image has no netCDF library, so we implement the classic file format
directly (CDF-1/CDF-2 as specified by the NetCDF "classic format spec").
This backs the 3D result writer (the reference writes real NetCDF via
libnetcdf — src/Common/IO.h:136-276, 350-388); any standard tool
(ncdump, xarray, scipy.io.netcdf_file) can read our output.

Supports: multiple dimensions (one unlimited), float/double/int/char
variables, global and per-variable attributes, record-variable appends.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NC_BYTE, NC_CHAR, NC_SHORT, NC_INT, NC_FLOAT, NC_DOUBLE = 1, 2, 3, 4, 5, 6
_NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = 0x0A, 0x0B, 0x0C
_TYPE_SIZE = {NC_BYTE: 1, NC_CHAR: 1, NC_SHORT: 2, NC_INT: 4, NC_FLOAT: 4, NC_DOUBLE: 8}
_TYPE_NP = {NC_BYTE: ">i1", NC_CHAR: "S1", NC_SHORT: ">i2", NC_INT: ">i4",
            NC_FLOAT: ">f4", NC_DOUBLE: ">f8"}


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def _pack_name(name: str) -> bytes:
    b = name.encode()
    return struct.pack(">I", len(b)) + b + b"\x00" * (_pad4(len(b)) - len(b))


def _pack_values(nc_type: int, values) -> bytes:
    if nc_type == NC_CHAR:
        b = values.encode() if isinstance(values, str) else bytes(values)
        out = struct.pack(">I", len(b)) + b
    else:
        arr = np.asarray(values, dtype=_TYPE_NP[nc_type]).ravel()
        out = struct.pack(">I", arr.size) + arr.tobytes()
    return out + b"\x00" * (_pad4(len(out)) - len(out))


def _pack_attrs(attrs: Dict[str, Tuple[int, object]]) -> bytes:
    if not attrs:
        return struct.pack(">II", 0, 0)
    out = struct.pack(">II", _NC_ATTRIBUTE, len(attrs))
    for name, (nc_type, values) in attrs.items():
        out += _pack_name(name) + struct.pack(">I", nc_type) + _pack_values(nc_type, values)
    return out


class Var:
    def __init__(self, name: str, nc_type: int, dims: Sequence[str],
                 attrs: Optional[Dict[str, Tuple[int, object]]] = None):
        self.name = name
        self.nc_type = nc_type
        self.dims = list(dims)
        self.attrs = attrs or {}
        self.begin = 0
        self.vsize = 0
        self.is_record = False
        self.shape: Tuple[int, ...] = ()


class NetCDF3Writer:
    """Write-once header, then random-access data/record writes."""

    def __init__(self, path: str, dims: Dict[str, Optional[int]],
                 gattrs: Optional[Dict[str, Tuple[int, object]]] = None,
                 version: int = 2):
        self.path = path
        self.dims = dict(dims)         # name -> size (None = unlimited)
        self.dim_order = list(dims.keys())
        self.gattrs = gattrs or {}
        self.vars: Dict[str, Var] = {}
        self.version = version         # 1 = classic, 2 = 64-bit offset
        self.numrecs = 0
        self._open = False

    def def_var(self, name: str, nc_type: int, dims: Sequence[str],
                attrs: Optional[Dict[str, Tuple[int, object]]] = None) -> None:
        self.vars[name] = Var(name, nc_type, dims, attrs)

    # ------------------------------------------------------------- layout
    def _layout(self) -> bytes:
        off_fmt = ">Q" if self.version == 2 else ">I"
        hdr = b"CDF" + bytes([self.version])
        hdr += struct.pack(">I", self.numrecs)

        if self.dims:
            hdr += struct.pack(">II", _NC_DIMENSION, len(self.dims))
            for name in self.dim_order:
                size = self.dims[name]
                hdr += _pack_name(name) + struct.pack(">I", 0 if size is None else size)
        else:
            hdr += struct.pack(">II", 0, 0)

        hdr += _pack_attrs(self.gattrs)

        # first pass: compute var entry sizes with dummy offsets
        def var_entry(v: Var, begin: int) -> bytes:
            e = _pack_name(v.name)
            e += struct.pack(">I", len(v.dims))
            for dn in v.dims:
                e += struct.pack(">I", self.dim_order.index(dn))
            e += _pack_attrs(v.attrs)
            e += struct.pack(">I", v.nc_type)
            e += struct.pack(">I", v.vsize & 0xFFFFFFFF)
            e += struct.pack(off_fmt, begin)
            return e

        for v in self.vars.values():
            v.is_record = bool(v.dims) and self.dims[v.dims[0]] is None
            fixed_dims = v.dims[1:] if v.is_record else v.dims
            nelems = 1
            shape = []
            for dn in fixed_dims:
                nelems *= self.dims[dn]
                shape.append(self.dims[dn])
            v.shape = tuple(shape)
            v.vsize = _pad4(nelems * _TYPE_SIZE[v.nc_type])

        if self.vars:
            body = struct.pack(">II", _NC_VARIABLE, len(self.vars))
            for v in self.vars.values():
                body += var_entry(v, 0)
        else:
            body = struct.pack(">II", 0, 0)

        header_size = len(hdr) + len(body)
        # assign offsets: fixed vars first, then the record block
        offset = header_size
        for v in self.vars.values():
            if not v.is_record:
                v.begin = offset
                offset += v.vsize
        self._recs_begin = offset
        self._recsize = 0
        for v in self.vars.values():
            if v.is_record:
                v.begin = offset + self._recsize
                self._recsize += v.vsize

        body = struct.pack(">II", _NC_VARIABLE, len(self.vars)) if self.vars else b""
        if self.vars:
            for v in self.vars.values():
                body += var_entry(v, v.begin)
        else:
            body = struct.pack(">II", 0, 0)
        return hdr + body

    def create(self) -> None:
        header = self._layout()
        with open(self.path, "wb") as f:
            f.write(header)
            # zero-fill fixed variable space
            fixed = sum(v.vsize for v in self.vars.values() if not v.is_record)
            if fixed:
                f.write(b"\x00" * fixed)
        self._open = True

    def open_append(self) -> None:
        """Re-open an existing file written with the identical schema.

        Verifies the on-disk header matches this writer's (modulo the
        numrecs field), adopts the existing record count and leaves all
        data in place — so interrupted runs can resume appending records
        (the reference's append-per-record design, src/Common/IO.h:350-388)
        without truncating what was already written.
        """
        header = self._layout()
        with open(self.path, "rb") as f:
            existing = f.read(len(header))
        if (len(existing) != len(header) or existing[:4] != header[:4]
                or existing[8:] != header[8:]):
            raise ValueError(
                f"{self.path}: incompatible NetCDF header, cannot append")
        self.numrecs = struct.unpack(">I", existing[4:8])[0]
        self._open = True

    # --------------------------------------------------------------- data
    def put_var(self, name: str, data) -> None:
        v = self.vars[name]
        arr = np.asarray(data).astype(_TYPE_NP[v.nc_type]).ravel()
        with open(self.path, "r+b") as f:
            f.seek(v.begin)
            f.write(arr.tobytes())

    def put_record(self, name: str, rec: int, data) -> None:
        v = self.vars[name]
        arr = np.asarray(data).astype(_TYPE_NP[v.nc_type]).ravel()
        with open(self.path, "r+b") as f:
            f.seek(v.begin + rec * self._recsize)
            f.write(arr.tobytes())
            if rec + 1 > self.numrecs:
                self.numrecs = rec + 1
                f.seek(4)
                f.write(struct.pack(">I", self.numrecs))
                # keep the file dense: extend to cover the full record block
                end = self._recs_begin + self.numrecs * self._recsize
                f.seek(0, 2)
                if f.tell() < end:
                    f.truncate(end)


# ------------------------------------------------------------------ reader
class NetCDF3Reader:
    """Reader for classic / 64-bit-offset files (round-trip + test oracle)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        magic = self.buf[:3]
        if magic != b"CDF":
            raise ValueError("not a classic NetCDF file")
        self.version = self.buf[3]
        self.pos = 4
        self.numrecs = self._u4()
        self.dims: List[Tuple[str, int]] = []
        self.gattrs: Dict[str, object] = {}
        self.vars: Dict[str, dict] = {}
        self._parse()

    def _u4(self) -> int:
        v = struct.unpack_from(">I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def _u8(self) -> int:
        v = struct.unpack_from(">Q", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def _name(self) -> str:
        n = self._u4()
        s = self.buf[self.pos:self.pos + n].decode()
        self.pos += _pad4(n)
        return s

    def _values(self, nc_type: int):
        n = self._u4()
        size = n * _TYPE_SIZE[nc_type]
        raw = self.buf[self.pos:self.pos + size]
        self.pos += _pad4(size)
        if nc_type == NC_CHAR:
            return raw.decode(errors="replace")
        return np.frombuffer(raw, dtype=_TYPE_NP[nc_type])

    def _attrs(self) -> Dict[str, object]:
        tag = self._u4()
        count = self._u4()
        out = {}
        if tag == _NC_ATTRIBUTE:
            for _ in range(count):
                name = self._name()
                t = self._u4()
                out[name] = self._values(t)
        return out

    def _parse(self) -> None:
        tag = self._u4()
        count = self._u4()
        if tag == _NC_DIMENSION:
            for _ in range(count):
                self.dims.append((self._name(), self._u4()))
        self.gattrs = self._attrs()
        tag = self._u4()
        count = self._u4()
        if tag == _NC_VARIABLE:
            for _ in range(count):
                name = self._name()
                nd = self._u4()
                dimids = [self._u4() for _ in range(nd)]
                attrs = self._attrs()
                nc_type = self._u4()
                vsize = self._u4()
                begin = self._u8() if self.version == 2 else self._u4()
                self.vars[name] = dict(dimids=dimids, attrs=attrs,
                                       nc_type=nc_type, vsize=vsize, begin=begin)
        self._recsize = sum(v["vsize"] for v in self.vars.values()
                            if v["dimids"] and self.dims[v["dimids"][0]][1] == 0)

    def read(self, name: str) -> np.ndarray:
        v = self.vars[name]
        shape = [self.dims[d][1] for d in v["dimids"]]
        is_rec = bool(shape) and shape[0] == 0
        dt = np.dtype(_TYPE_NP[v["nc_type"]])
        if not is_rec:
            n = int(np.prod(shape)) if shape else 1
            arr = np.frombuffer(self.buf, dtype=dt, count=n, offset=v["begin"])
            return arr.reshape(shape)
        shape[0] = self.numrecs
        per_rec = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        out = np.empty(shape, dtype=dt)
        for r in range(self.numrecs):
            off = v["begin"] + r * self._recsize
            out[r] = np.frombuffer(self.buf, dtype=dt, count=per_rec,
                                   offset=off).reshape(shape[1:])
        return out
