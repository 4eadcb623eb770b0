"""CF/NetCDF file I/O (port of ``pism_tpu/io/nc4.py``).

Two on-disk formats, as PISM's ``-o_format``:

- NetCDF-4 (``format="netcdf4"``), HDF5 with netCDF-4 conventions
  (dimension scales, ``_Netcdf4Dimid``, ``_NCProperties``), written and
  read through ``h5py``. ``h5py`` is imported only when such a file is
  opened; without it :class:`File` raises :class:`NetCDF4Unavailable`,
  which names ``-o_format netcdf3``. Nothing falls back to the other
  format.
- Classic NetCDF (``format="netcdf3"``, CDF-2), written by
  :class:`ClassicWriteFile` and read by :class:`ClassicFile`, both on
  ``scipy.io.netcdf_file``. Classic NetCDF has one unlimited dimension,
  which comes first in a variable's shape, and no 64-bit or boolean
  variables (they are stored as int32 and int8).

All three classes share one interface, so the checkpoint and output code
never reach into a backend: ``define_dimension``, ``has_dimension``,
``define_variable``, ``write``, ``append_time``, ``read``, ``read_attrs``,
``set_var_attr``, ``set_global_attr``, ``get_global_attr``, ``flush``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_NC_PROPS = b"version=2,pism_tpu=0.1"


class NetCDF4Unavailable(RuntimeError):
    """A NetCDF-4 file was opened on a machine without h5py."""


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise NetCDF4Unavailable(
            "NetCDF-4 files need the h5py package, which is not installed; "
            "write classic NetCDF instead (-o_format netcdf3, i.e. "
            "output.format = netcdf3)") from e
    return h5py


def _is_classic(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(3) == b"CDF"


class File:
    """NetCDF file (PISM ``pism::File``). ``File(path, "r")`` sniffs the
    magic number and serves a classic file through :class:`ClassicFile`;
    ``File(path, "w", format="netcdf3")`` is a :class:`ClassicWriteFile`;
    every other open goes through h5py."""

    def __new__(cls, path: str, mode: str = "r", format: str = "netcdf4"):
        if cls is File and mode == "r" and _is_classic(path):
            return ClassicFile(path)
        if cls is File and mode in ("w", "w-", "x") and format == "netcdf3":
            return ClassicWriteFile(path)
        if format not in ("netcdf4", "netcdf3"):
            raise ValueError(f"unknown NetCDF format {format!r}")
        return super().__new__(cls)

    #: gzip deflate level of newly defined non-scalar variables
    #: (output.compression_level; 0 = off)
    compression_level = 0

    @classmethod
    def set_compression_level(cls, level: int):
        cls.compression_level = int(level)

    def __init__(self, path: str, mode: str = "r", format: str = "netcdf4"):
        if mode in ("a", "r+") and _is_classic(path):
            raise ValueError(f"{path} is a classic NetCDF file, which is "
                             "written in one pass and cannot be appended to")
        h5py = _h5py()
        self._h5py = h5py
        self.h5 = h5py.File(path, mode)
        if mode in ("w", "w-", "x"):
            self.h5.attrs.create("_NCProperties", _NC_PROPS)
        self._dims: Dict[str, int] = {}
        if mode in ("r", "a", "r+"):
            for name, ds in self.h5.items():
                if isinstance(ds, h5py.Dataset) \
                        and ds.attrs.get("CLASS") == b"DIMENSION_SCALE":
                    self._dims[name] = ds.shape[0] if ds.shape else 0

    # -- dimensions ----------------------------------------------------------
    def define_dimension(self, name: str, length: Optional[int],
                         values: Optional[np.ndarray] = None,
                         attrs: Optional[dict] = None):
        """length=None creates an unlimited (time) dimension."""
        if name in self.h5:
            return
        if length is None:
            ds = self.h5.create_dataset(name, shape=(0,), maxshape=(None,),
                                        dtype="f8")
            self._dims[name] = 0
        else:
            data = values if values is not None else np.zeros(length)
            ds = self.h5.create_dataset(name, data=np.asarray(data, "f8"))
            self._dims[name] = length
        ds.make_scale(name)
        ds.attrs["_Netcdf4Dimid"] = np.int32(len(self._dims) - 1)
        for k, v in (attrs or {}).items():
            ds.attrs[k] = v

    def has_dimension(self, name: str) -> bool:
        return name in self._dims

    # -- variables -----------------------------------------------------------
    def define_variable(self, name: str, dims, dtype="f8",
                        attrs: Optional[dict] = None):
        if name in self.h5:
            return self.h5[name]
        shape = tuple(self.h5[d].shape[0] for d in dims)
        maxshape = tuple(None if self.h5[d].maxshape[0] is None
                         else self.h5[d].shape[0] for d in dims)
        fill = (attrs or {}).get("_FillValue")
        kw = {}
        if self.compression_level > 0 and len(shape) >= 2:
            kw = dict(compression="gzip",
                      compression_opts=min(self.compression_level, 9),
                      chunks=True)
        ds = self.h5.create_dataset(name, shape=shape, maxshape=maxshape,
                                    dtype=dtype, fillvalue=fill, **kw)
        for i, d in enumerate(dims):
            ds.dims[i].attach_scale(self.h5[d])
        for k, v in (attrs or {}).items():
            if k != "_FillValue":
                ds.attrs[k] = v
        return ds

    def write(self, name: str, data, dims=None, attrs=None, time_index=None):
        """Write a variable; with time_index, append or overwrite one record
        of a time-dependent variable (first dim = time)."""
        data = np.asarray(data)
        if name not in self.h5:
            if dims is None:
                raise ValueError(f"new variable {name!r} needs dims")
            self.define_variable(name, dims, dtype=data.dtype, attrs=attrs)
        ds = self.h5[name]
        if time_index is None:
            ds[...] = data
        else:
            if ds.shape[0] <= time_index:
                ds.resize(time_index + 1, axis=0)
            ds[time_index, ...] = data

    def append_time(self, t: float, name: str = "time"):
        ds = self.h5[name]
        n = ds.shape[0]
        ds.resize(n + 1, axis=0)
        ds[n] = t
        return n

    def read(self, name: str) -> np.ndarray:
        return np.asarray(self.h5[name])

    def read_slice(self, name: str, index: int) -> np.ndarray:
        """Record ``index`` of a variable's first (time) dimension."""
        return np.asarray(self.h5[name][index])

    def shape(self, name: str) -> tuple:
        return tuple(self.h5[name].shape)

    def read_attrs(self, name: str) -> dict:
        return {k: (v.decode() if isinstance(v, bytes) else v)
                for k, v in self.h5[name].attrs.items()}

    def variables(self):
        return [k for k, v in self.h5.items()
                if isinstance(v, self._h5py.Dataset)
                and v.attrs.get("CLASS") != b"DIMENSION_SCALE"]

    def set_var_attr(self, name: str, key: str, value):
        self.h5[name].attrs[key] = value

    def set_global_attr(self, key: str, value):
        self.h5.attrs[key] = value

    def get_global_attr(self, key: str):
        v = self.h5.attrs.get(key)
        return v.decode() if isinstance(v, bytes) else v

    def has_variable(self, name):
        return name in self.h5

    def flush(self):
        self.h5.flush()

    def close(self):
        self.h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _decode(v):
    return v.decode() if isinstance(v, bytes) else v


def _native(arr):
    """Classic NetCDF data is big-endian; torch takes native byte order."""
    if arr.dtype.byteorder == ">":
        return arr.astype(arr.dtype.newbyteorder("="))
    return arr


class ClassicFile:
    """Read-only classic NetCDF (CDF-1/2/5) through scipy; ``mmap=True``
    maps the file instead of reading it whole (a reader of single records,
    ``read_slice``)."""

    def __init__(self, path: str, mmap: bool = False):
        from scipy.io import netcdf_file
        self.nc = netcdf_file(path, "r", mmap=mmap, maskandscale=False)

    def has_dimension(self, name: str) -> bool:
        return name in self.nc.dimensions

    def read(self, name: str) -> np.ndarray:
        return _native(np.array(self.nc.variables[name].data))

    def read_slice(self, name: str, index: int) -> np.ndarray:
        """Record ``index`` of a variable's first (time) dimension."""
        return _native(np.array(self.nc.variables[name].data[index]))

    def shape(self, name: str) -> tuple:
        return tuple(self.nc.variables[name].shape)

    def read_attrs(self, name: str) -> dict:
        return {k: _decode(v)
                for k, v in self.nc.variables[name]._attributes.items()}

    def variables(self):
        return [k for k in self.nc.variables if k not in self.nc.dimensions]

    def get_global_attr(self, key: str):
        return _decode(self.nc._attributes.get(key))

    def has_variable(self, name):
        return name in self.nc.variables

    def close(self):
        self.nc.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class ClassicWriteFile(ClassicFile):
    """Classic NetCDF (CDF-2, 64-bit offset) writer through scipy, with the
    interface of :class:`File`. scipy keeps the data in memory and writes
    the whole file on ``flush`` and ``close``."""

    def __init__(self, path: str):
        from scipy.io import netcdf_file
        self.nc = netcdf_file(path, "w", version=2)

    def define_dimension(self, name, length, values=None, attrs=None):
        if name in self.nc.dimensions:
            return
        self.nc.createDimension(name, length)
        v = self.nc.createVariable(name, "d", (name,))
        if length is not None:
            v[:] = np.asarray(values if values is not None
                              else np.zeros(length), "d")
        for k, val in (attrs or {}).items():
            setattr(v, k, val)

    def define_variable(self, name, dims, dtype="f8", attrs=None):
        if name in self.nc.variables:
            return self.nc.variables[name]
        tc = np.dtype(dtype).char
        if np.dtype(dtype) == np.int64:
            tc = "i"      # classic NetCDF has no 64-bit integers
        elif tc == "?":
            tc = "b"
        v = self.nc.createVariable(name, tc, tuple(dims))
        for k, val in (attrs or {}).items():
            if k != "_FillValue":
                setattr(v, k, val)
        return v

    def write(self, name, data, dims=None, attrs=None, time_index=None):
        data = np.asarray(data)
        if name not in self.nc.variables:
            if dims is None:
                raise ValueError(f"new variable {name!r} needs dims")
            self.define_variable(name, dims, dtype=data.dtype, attrs=attrs)
        v = self.nc.variables[name]
        if time_index is None:
            v[:] = data.astype(v.data.dtype) if v.shape else data
        else:
            v[time_index] = data[0] if data.ndim == len(v.dimensions) \
                else data

    def append_time(self, t, name="time"):
        v = self.nc.variables[name]
        n = v.shape[0] if v.shape else 0
        v[n] = float(t)
        return n

    def set_var_attr(self, name, key, value):
        setattr(self.nc.variables[name], key, value)

    def set_global_attr(self, key, value):
        setattr(self.nc, key, value)

    def flush(self):
        self.nc.flush()
