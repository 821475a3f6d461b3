"""Object-store IO with the local filesystem as the default (counterpart:
`slide_tpu/data/object_io.py`): every reader and writer takes plain paths;
`s3://` paths go to a client registered with `register_s3_client`, any
object with `.get(path) -> bytes` and `.put(path, bytes)`.

The port has no PyYAML: `TextIO` writes a .yaml / .yml object as JSON,
which is YAML too (PyYAML reads it back), and reads such a file where it is
JSON; a file in YAML's block style raises."""

from __future__ import annotations

import io
import json
import os
import pickle
from typing import Any, Optional

import numpy as np

_S3_CLIENT: Optional[Any] = None


def register_s3_client(client: Any) -> None:
    """Register the object-store client that `s3://` paths go to."""
    global _S3_CLIENT
    _S3_CLIENT = client


def _is_remote(path: str) -> bool:
    return path.startswith("s3://")


def _read_bytes(path: str) -> bytes:
    if _is_remote(path):
        if _S3_CLIENT is None:
            raise RuntimeError(f"no object-store client registered for {path}; "
                               "call register_s3_client() first")
        return _S3_CLIENT.get(path)
    with open(path, "rb") as f:
        return f.read()


def _write_bytes(path: str, data: bytes) -> None:
    if _is_remote(path):
        if _S3_CLIENT is None:
            raise RuntimeError(f"no object-store client registered for {path}")
        _S3_CLIENT.put(path, data)
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


class NpzIO:
    """npz files: `read(path) -> {name: array}`, `write(path, **arrays)`."""

    def read(self, path: str, update_cache: bool = False) -> dict:
        with np.load(io.BytesIO(_read_bytes(path))) as d:
            return {k: d[k] for k in d.files}

    def write(self, path: str, **arrays) -> None:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        _write_bytes(path, buf.getvalue())


class TextIO:
    """Text files: .yaml / .yml parse to objects (their JSON form, see the
    module docstring), anything else is text."""

    def read(self, path: str):
        data = _read_bytes(path).decode("utf-8")
        if path.endswith((".yaml", ".yml")):
            try:
                return json.loads(data)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}: only YAML in its JSON form is read without "
                                 f"PyYAML ({e})") from e
        return data

    def write(self, path: str, content) -> None:
        if path.endswith((".yaml", ".yml")) and not isinstance(content, str):
            content = json.dumps(content, indent=2, sort_keys=True) + "\n"
        _write_bytes(path, content.encode("utf-8"))


class PickleIO:
    """Pickle files (the checkpoints' format)."""

    def read(self, path: str):
        return pickle.loads(_read_bytes(path))

    def write(self, path: str, obj) -> None:
        _write_bytes(path, pickle.dumps(obj))
