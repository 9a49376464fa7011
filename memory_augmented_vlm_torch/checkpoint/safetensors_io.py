"""The safetensors format, read and written without the `safetensors`
package (which the machines the port runs on need not have).

A file is an 8-byte little-endian header length N, then N bytes of JSON
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}}` and an optional
`"__metadata__": {str: str}`; the writer pads it with spaces to a multiple
of 8), then the tensors' raw little-endian bytes, the offsets counted from
the end of the header. The writer lays the tensors out in name order with
no gaps, as the format's validators require.

`SafetensorsFile` maps a file and hands out one tensor at a time as a CPU
tensor over the map, in the dtype the file holds (bf16 stays bf16), so a
loader can move and convert each tensor to its device before it reads the
next, and the host never holds a copy of the model. A tensor over the map
keeps the map alive; copy a tensor that must not hold the file mapped.
`CheckpointReader` does the same for a checkpoint directory: its shards
through `model.safetensors.index.json`, else every `*.safetensors` in it
(JAX `hf_import.load_safetensors_dir`).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, List, Mapping, Optional, Tuple

import torch

DTYPES: Dict[str, torch.dtype] = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "I16": torch.int16, "I32": torch.int32,
    "I64": torch.int64, "U8": torch.uint8, "BOOL": torch.bool,
}
NAMES: Dict[torch.dtype, str] = {v: k for k, v in DTYPES.items()}

INDEX_FILE = "model.safetensors.index.json"
# the header of a well-formed file is far below this (the format's own cap)
MAX_HEADER_BYTES = 100_000_000


class SafetensorsFile:
    """One `.safetensors` file, memory-mapped (copy on write, so a tensor
    over it is writable without touching the file)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: too short for a safetensors file")
            (n,) = struct.unpack("<Q", head)
            if n > MAX_HEADER_BYTES:
                raise ValueError(f"{path}: header of {n} bytes")
            header = json.loads(f.read(n))
            size = os.fstat(f.fileno()).st_size
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n \
                else None
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._start = 8 + n
        self._entries = header
        for name, e in header.items():
            begin, end = e["data_offsets"]
            count = 1
            for d in e["shape"]:
                count *= d
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name} has dtype {e['dtype']}, not one of "
                                 f"{sorted(DTYPES)}")
            if end - begin != count * DTYPES[e["dtype"]].itemsize or \
                    self._start + end > size:
                raise ValueError(f"{path}: {name}'s offsets {begin, end} do not hold "
                                 f"{e['dtype']} {e['shape']}")

    def keys(self) -> List[str]:
        return list(self._entries)

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._entries[name]["shape"])

    def get(self, name: str) -> torch.Tensor:
        """The tensor, a CPU view over the map (a copy where its offset is
        not a multiple of its element size)."""
        e = self._entries[name]
        dtype, shape = DTYPES[e["dtype"]], e["shape"]
        begin, end = e["data_offsets"]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        offset = self._start + begin
        if offset % dtype.itemsize:
            buf = bytearray(self._map[offset:self._start + end])
            return torch.frombuffer(buf, dtype=dtype).reshape(shape)
        count = (end - begin) // dtype.itemsize
        return torch.frombuffer(self._map, dtype=dtype, count=count,
                                offset=offset).reshape(shape)

    def close(self):
        """Drop the file's reference to the map. A tensor over it holds one
        of its own, so the map is unmapped when the last of them goes
        (closing it under a live tensor would leave the tensor pointing at
        unmapped memory)."""
        self._map = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _header(entries: List[Tuple[str, torch.dtype, Tuple[int, ...], int]],
            metadata: Optional[Mapping[str, str]]) -> bytes:
    header: Dict[str, object] = {}
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise TypeError("safetensors metadata maps str to str")
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, dtype, shape, nbytes in entries:
        header[name] = {"dtype": NAMES[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    return struct.pack("<Q", len(raw)) + raw


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None,
              dtype: Optional[torch.dtype] = None) -> None:
    """Write `tensors` (on any device, any layout) to `path`, in name
    order, each cast to `dtype` if given. Each tensor is cast where it lies
    and copied to the host as it is written, so the host holds one tensor
    at a time. The file appears under its name once it is whole."""
    names = sorted(tensors)
    dtypes = {n: dtype or tensors[n].dtype for n in names}
    for name in names:
        if dtypes[name] not in NAMES:
            raise ValueError(f"{name}: dtype {dtypes[name]} has no safetensors name")
    entries = [(n, dtypes[n], tuple(tensors[n].shape),
                tensors[n].numel() * dtypes[n].itemsize) for n in names]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_header(entries, metadata))
        for name in names:
            t = tensors[name].detach().to(dtype=dtypes[name]).contiguous().to("cpu")
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())
    os.replace(tmp, path)


class CheckpointReader:
    """The tensors of a checkpoint directory by name, across its shards."""

    def __init__(self, path: str):
        self.path = path
        index = os.path.join(path, INDEX_FILE)
        if os.path.exists(index):
            with open(index) as f:
                files = sorted(set(json.load(f)["weight_map"].values()))
        else:
            files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
        self._files = [SafetensorsFile(os.path.join(path, f)) for f in files]
        self._where: Dict[str, SafetensorsFile] = {}
        for f in self._files:
            for name in f.keys():
                if name in self._where:
                    raise ValueError(f"{path}: {name} is in {self._where[name].path} "
                                     f"and {f.path}")
                self._where[name] = f

    def keys(self) -> List[str]:
        return list(self._where)

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._where[name].shape(name)

    def get(self, name: str) -> torch.Tensor:
        return self._where[name].get(name)

    def close(self):
        for f in self._files:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
