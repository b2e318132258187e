"""Evaluation metrics: confusion matrix, accuracies, mean IoU.

The port's copy of ``rovinasemanticsegmentation_tpu/utils/metrics.py``, kept so that
the port imports nothing of the JAX package.

Reproduces the de-facto integration metrics of the reference evaluators
(``src/test.cpp:185-228``,
``src/test_multi.cpp:219-268``):

- pixels count only where both prediction and ground truth are >= 0;
- ``confusion[gt, pred]`` raw counts, printed row-normalized by class count;
- global accuracy = trace / total;
- class-average accuracy = mean over classes of diag / class count (empty
  classes divide by 1, test_multi.cpp:256);
- mean IoU = mean over classes of diag / (gt count + vote count - diag), with
  a zero denominator replaced by 1 (test_multi.cpp:257-258).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class ConfusionAccumulator:
    """Streaming confusion-matrix accumulator for one label layer."""

    num_classes: int
    confusion: np.ndarray = field(init=False)

    def __post_init__(self) -> None:
        self.confusion = np.zeros(
            (self.num_classes, self.num_classes), dtype=np.int64
        )

    def update(self, prediction: np.ndarray, ground_truth: np.ndarray) -> None:
        """Accumulate from integer label maps of identical shape.

        Only pixels with both pred >= 0 and gt >= 0 count
        (test_multi.cpp:222-231).
        """
        pred = np.asarray(prediction).ravel().astype(np.int64)
        gt = np.asarray(ground_truth).ravel().astype(np.int64)
        valid = (pred >= 0) & (gt >= 0)
        pred, gt = pred[valid], gt[valid]
        np.add.at(self.confusion, (gt, pred), 1)

    # ------------------------------------------------------------------
    @property
    def total(self) -> int:
        return int(self.confusion.sum())

    @property
    def class_counts(self) -> np.ndarray:
        """Ground-truth pixels per class."""
        return self.confusion.sum(axis=1)

    @property
    def vote_counts(self) -> np.ndarray:
        """Predicted pixels per class."""
        return self.confusion.sum(axis=0)

    def global_accuracy(self) -> float:
        total = self.total
        diag = np.trace(self.confusion)
        return 100.0 * diag / total if total else 0.0

    def class_average_accuracy(self) -> float:
        counts = np.maximum(self.class_counts, 1)  # test_multi.cpp:256
        per_class = 100.0 * np.diag(self.confusion) / counts
        return float(per_class.sum() / self.num_classes)

    def per_class_iou(self) -> np.ndarray:
        diag = np.diag(self.confusion)
        denom = self.class_counts + self.vote_counts - diag
        denom = np.where(denom == 0, 1, denom)  # test_multi.cpp:258
        return 100.0 * diag / denom

    def mean_iou(self) -> float:
        return float(self.per_class_iou().sum() / self.num_classes)

    # ------------------------------------------------------------------
    def report(self, class_names: Optional[Sequence[str]] = None) -> str:
        """Render the reference evaluator's report (test_multi.cpp:240-268)."""
        names = list(class_names or [str(i) for i in range(self.num_classes)])
        lines: List[str] = ["confusion:"]
        counts = np.maximum(self.class_counts, 1)
        row_pct = 100.0 * self.confusion / counts[:, None]
        for i in range(self.num_classes):
            name = names[i][:15].ljust(15)
            row = "".join(f" {row_pct[i, j]:6.2f}" for j in range(self.num_classes))
            lines.append(f"{name}{row}   out of {self.class_counts[i]} pixels")
        lines.append(f"Global accuracy:         {self.global_accuracy():6.2f} ")
        lines.append(f"Class averge accuracy:   {self.class_average_accuracy():6.2f} ")
        lines.append(f"Intersection over union: {self.mean_iou():6.2f} ")
        return "\n".join(lines)
