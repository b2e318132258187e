"""Dataset IO: CSV and libforest binary dataset formats.

The port's copy of ``rovinasemanticsegmentation_tpu/utils/data_io.py``, kept so that
the port imports nothing of the JAX package.

Capability parity with the libforest data providers/writers
(``third-party/libforest/src/data.cpp:387-475``,
``include/libforest/data.h:466-597``):

- CSV: one row per point, the class column (default 0) holds a string label;
  labels are mapped to integers in sorted order (ClassLabelMap's
  computeIntClassLabels semantics);
- libforest binary: int32 N, then per point int32 label + DataPoint body
  (int32 D + D float32s, data.cpp:84-109).
"""

from __future__ import annotations

import csv
import struct
from typing import BinaryIO, List, TextIO, Tuple

import numpy as np


def read_csv_dataset(
    stream: TextIO, class_column_index: int = 0
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """-> (features [N, D], labels [N] int32, sorted label names)."""
    rows: List[List[str]] = [r for r in csv.reader(stream) if r]
    if not rows:
        return np.zeros((0, 0), np.float32), np.zeros(0, np.int32), []
    names: List[str] = []
    feats: List[List[float]] = []
    raw_labels: List[str] = []
    for row in rows:
        label = row[class_column_index]
        raw_labels.append(label)
        if label not in names:
            names.append(label)
        feats.append(
            [float(v) for i, v in enumerate(row) if i != class_column_index]
        )
    sorted_names = sorted(names)
    mapping = {n: i for i, n in enumerate(sorted_names)}
    labels = np.array([mapping[l] for l in raw_labels], np.int32)
    return np.asarray(feats, np.float32), labels, sorted_names


def write_csv_dataset(
    stream: TextIO, features: np.ndarray, labels: np.ndarray
) -> None:
    writer = csv.writer(stream)
    for x, y in zip(np.asarray(features), np.asarray(labels)):
        writer.writerow([int(y)] + [repr(float(v)) for v in x])


def read_libsvm_dataset(
    stream: TextIO, num_features: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """LIBSVM sparse text: ``label idx:val ...`` per line, 1-based indices.

    The reference declares ``LIBSVMDataProvider``/``LIBSVMDataPWriter``
    (``third-party/libforest/include/libforest/data.h:511,570``)
    without shipping an implementation; this implements the standard format
    they name. Missing indices are zeros; ``num_features`` pads/clips the
    width (0 = infer from the data). ``#`` comments and blank lines are
    skipped.
    """
    rows: List[dict] = []
    labels: List[int] = []
    max_idx = num_features
    for line in stream:
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        labels.append(int(float(parts[0])))
        entries = {}
        for tok in parts[1:]:
            idx, val = tok.split(":")
            i = int(idx)
            if i < 1:
                raise ValueError(f"LIBSVM indices are 1-based, got {i}")
            entries[i] = float(val)
            max_idx = max(max_idx, i)
        rows.append(entries)
    d = max_idx if num_features == 0 else num_features
    x = np.zeros((len(rows), d), np.float32)
    for r, entries in enumerate(rows):
        for i, v in entries.items():
            if i <= d:
                x[r, i - 1] = v
    return x, np.asarray(labels, np.int32)


def write_libsvm_dataset(
    stream: TextIO, features: np.ndarray, labels: np.ndarray
) -> None:
    """Sparse LIBSVM text output (zeros omitted, 1-based indices)."""
    for x, y in zip(np.asarray(features), np.asarray(labels)):
        toks = [str(int(y))]
        for i, v in enumerate(x):
            if v != 0:
                toks.append(f"{i + 1}:{float(v):g}")
        stream.write(" ".join(toks) + "\n")


def read_libforest_dataset(f: BinaryIO) -> Tuple[np.ndarray, np.ndarray]:
    """data.cpp:442-459: N, then per point (label, dim, values)."""
    (n,) = struct.unpack("<i", f.read(4))
    labels = np.zeros(n, np.int32)
    feats: List[np.ndarray] = []
    for i in range(n):
        (labels[i],) = struct.unpack("<i", f.read(4))
        (d,) = struct.unpack("<i", f.read(4))
        feats.append(np.frombuffer(f.read(4 * d), dtype="<f4"))
    return np.stack(feats) if n else np.zeros((0, 0), np.float32), labels


def write_libforest_dataset(
    f: BinaryIO, features: np.ndarray, labels: np.ndarray
) -> None:
    """data.cpp:465-475."""
    features = np.asarray(features, np.float32)
    labels = np.asarray(labels, np.int32)
    f.write(struct.pack("<i", len(labels)))
    for x, y in zip(features, labels):
        f.write(struct.pack("<i", int(y)))
        f.write(struct.pack("<i", len(x)))
        f.write(x.astype("<f4").tobytes())
