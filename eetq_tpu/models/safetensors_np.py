"""A numpy reader and writer of the safetensors file format.

Layout: an 8-byte little-endian header length N, N bytes of JSON
(`{"__metadata__": {...}, name: {"dtype", "shape", "data_offsets"}}`,
padded with spaces to a multiple of 8), then the tensors' bytes back to
back, row-major, little-endian. The writer lays tensors out as the
reference implementation does — by descending dtype rank, then by name —
so its files are byte-identical to the `safetensors` package's. bf16 is
`ml_dtypes.bfloat16`, a JAX dependency.
"""

from __future__ import annotations

import json
import os
import struct

import ml_dtypes
import numpy as np

# safetensors dtype names, in the reference implementation's enum order
# (the writer sorts by descending rank).
_DTYPES = {
    "BOOL": np.dtype(np.bool_),
    "U8": np.dtype(np.uint8),
    "I8": np.dtype(np.int8),
    "I16": np.dtype(np.int16),
    "U16": np.dtype(np.uint16),
    "F16": np.dtype(np.float16),
    "BF16": np.dtype(ml_dtypes.bfloat16),
    "I32": np.dtype(np.int32),
    "U32": np.dtype(np.uint32),
    "F32": np.dtype(np.float32),
    "F64": np.dtype(np.float64),
    "I64": np.dtype(np.int64),
    "U64": np.dtype(np.uint64),
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}
_RANK = {name: i for i, name in enumerate(_DTYPES)}


def save_file(
    tensors: dict[str, np.ndarray], path: str,
    metadata: dict[str, str] | None = None,
) -> None:
    """Write `tensors` (name -> numpy array) to a .safetensors file."""
    arrays = {}
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        if arr.dtype not in _NAMES:
            raise TypeError(f"{name}: unsupported dtype {arr.dtype}")
        # (np.ascontiguousarray would turn a 0-d array into 1-d)
        arrays[name] = arr if arr.flags.c_contiguous else arr.copy(order="C")
    order = sorted(
        arrays, key=lambda n: (-_RANK[_NAMES[arrays[n].dtype]], n)
    )
    header: dict = {}
    if metadata:
        header["__metadata__"] = {k: metadata[k] for k in sorted(metadata)}
    offset = 0
    for name in order:
        arr = arrays[name]
        header[name] = {
            "dtype": _NAMES[arr.dtype],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + arr.nbytes],
        }
        offset += arr.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            f.write(arrays[name].reshape(-1).view(np.uint8).data)


class SafeTensorsFile:
    """Read access to one .safetensors file: `keys()`, `get_tensor(name)`,
    `metadata()`. The data region is memory-mapped, so a tensor's bytes are
    read only when it is asked for."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self._meta = header.pop("__metadata__", None) or {}
        self._header = header
        if os.path.getsize(path) > 8 + n:
            self._data = np.memmap(
                path, dtype=np.uint8, mode="r", offset=8 + n
            )
        else:  # every tensor is empty
            self._data = np.zeros((0,), np.uint8)

    def keys(self) -> list[str]:
        return list(self._header)

    def metadata(self) -> dict[str, str]:
        return dict(self._meta)

    def get_tensor(self, name: str) -> np.ndarray:
        info = self._header[name]
        begin, end = info["data_offsets"]
        raw = np.array(self._data[begin:end])
        return raw.view(_DTYPES[info["dtype"]]).reshape(info["shape"])

    def close(self) -> None:
        self._data = None

    def __enter__(self) -> "SafeTensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def safe_open(path: str) -> SafeTensorsFile:
    return SafeTensorsFile(path)


def load_file(path: str) -> dict[str, np.ndarray]:
    """Every tensor of a .safetensors file, name -> numpy array."""
    with safe_open(path) as f:
        return {name: f.get_tensor(name) for name in f.keys()}
