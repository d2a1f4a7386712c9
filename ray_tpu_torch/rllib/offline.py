"""Offline IO: sample batches to/from JSON files (reference: rllib/offline/
json_writer.py + json_reader.py)."""

from __future__ import annotations

import base64
import json
import os
from typing import Iterator, List, Optional

import numpy as np

from .sample_batch import SampleBatch


def _encode_array(a: np.ndarray) -> dict:
    a = np.asarray(a)
    return {"__ndarray__": base64.b64encode(a.tobytes()).decode(),
            "dtype": str(a.dtype), "shape": list(a.shape)}


def _decode_array(d: dict) -> np.ndarray:
    buf = base64.b64decode(d["__ndarray__"])
    return np.frombuffer(buf, dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()


class JsonWriter:
    """Append sample batches to newline-delimited JSON files."""

    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.max_file_size = max_file_size
        self._file = None
        self._file_index = 0

    def _out(self):
        if self._file is None or self._file.tell() > self.max_file_size:
            if self._file is not None:
                self._file.close()
            name = os.path.join(self.path, f"batches-{self._file_index:05d}.json")
            self._file_index += 1
            self._file = open(name, "a")
        return self._file

    def write(self, batch: SampleBatch) -> None:
        record = {k: _encode_array(v) for k, v in batch.items()}
        out = self._out()
        out.write(json.dumps(record) + "\n")
        out.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class JsonReader:
    """Iterate sample batches from a JsonWriter directory (looping)."""

    def __init__(self, path: str, shuffle: bool = True, seed: int = 0):
        self.files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".json"))
        if not self.files:
            raise ValueError(f"no .json batch files under {path}")
        self.rng = np.random.RandomState(seed)
        self.shuffle = shuffle
        self._batches: List[SampleBatch] = []
        for fname in self.files:
            with open(fname) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    record = json.loads(line)
                    self._batches.append(SampleBatch(
                        {k: _decode_array(v) for k, v in record.items()}))

    def next(self) -> SampleBatch:
        idx = (self.rng.randint(len(self._batches)) if self.shuffle
               else 0)
        return self._batches[idx]

    def __iter__(self) -> Iterator[SampleBatch]:
        while True:
            yield self.next()

    def all(self) -> SampleBatch:
        return SampleBatch.concat_samples(self._batches)
