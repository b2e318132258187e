"""The feature row layout that kernels A and B share.

A frame's features are one row per stride-grid point. The frame path keeps
them as packed ``uint8`` rows (``[P, row_bytes]``), in three parts:

- bytes ``[0, pc)``: the 8-bit Lab patch, ``pc = R * R * 3`` (0 when the
  colour patch is off);
- from ``tail_off = round_up(pc, 4)``: the other features (depth, height,
  normal angle, in that order) as float32;
- zero padding up to ``row_bytes = round_up(tail_off + 4 k, 16)``, so that a
  run of rows is one 16-byte aligned span (384 B for the 366-feature
  default, three 128-byte lines).

Feature ``f`` reads as ``float(row[f])`` when ``f < pc`` and as the float32
at ``tail_off + 4 (f - pc)`` otherwise. The 8-bit -> float conversion is
exact, so a split ``x >= thr`` branches as it does on the float row. A plain
float32 ``[P, D]`` matrix is the same format with ``pc = tail_off = 0`` and
``row_bytes = 4 D``, so one descent kernel reads both.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class RowLayout:
    """Where each of ``num_features`` features lies in a row of bytes."""

    patch_bytes: int  # pc: features [0, pc) are uint8
    tail_off: int  # byte offset of the float32 features [pc, D)
    row_bytes: int
    num_features: int  # D

    @classmethod
    def packed(cls, patch_bytes: int, num_tail: int) -> "RowLayout":
        """8-bit patch bytes, then ``num_tail`` float32, padded to 16 B."""
        tail_off = _round_up(patch_bytes, 4)
        return cls(
            patch_bytes, tail_off, _round_up(tail_off + 4 * num_tail, 16),
            patch_bytes + num_tail,
        )

    @classmethod
    def float32(cls, num_features: int) -> "RowLayout":
        """A plain float32 ``[P, D]`` matrix seen as rows of bytes."""
        return cls(0, 0, 4 * num_features, num_features)

    @property
    def tail_slots(self) -> int:
        """float32 slots from ``tail_off`` to the end of the row."""
        return (self.row_bytes - self.tail_off) // 4


def check_rows(rows: torch.Tensor, layout: RowLayout) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2 \
            or rows.shape[1] != layout.row_bytes or not rows.is_contiguous():
        raise ValueError(
            f"rows must be contiguous [P, {layout.row_bytes}] uint8, got "
            f"{tuple(rows.shape)} {rows.dtype}"
        )


def tail_view(rows: torch.Tensor, layout: RowLayout) -> torch.Tensor:
    """The float32 ``[P, tail_slots]`` view of the rows' tail (and padding)."""
    check_rows(rows, layout)
    return rows.view(torch.float32)[:, layout.tail_off // 4 :]


def unpack_rows(rows: torch.Tensor, layout: RowLayout) -> torch.Tensor:
    """Packed rows -> float32 ``[P, D]`` features (the plain reading)."""
    check_rows(rows, layout)
    k = layout.num_features - layout.patch_bytes
    tail = tail_view(rows, layout)[:, :k]
    if layout.patch_bytes == 0:
        return tail
    patch = rows[:, : layout.patch_bytes].to(torch.float32)
    return torch.cat([patch, tail], dim=1)
