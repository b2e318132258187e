"""2D dense-CRF demo (parity with densecrf's dense_inference example).

Usage: python -m rovinasemanticsegmentation_tpu_torch.cli.dense_inference \
           <image.ppm> <annotation.ppm> <output.ppm> [--device cuda|cpu]

Counterpart of ``rovinasemanticsegmentation_tpu/cli/dense_inference.py``,
after ``examples/dense_inference.cpp:54-115`` of densecrf: unary energies
from a noisy annotation with GT_PROB = 0.5, a grid Gaussian pairwise
(sx = sy = 3, Potts 3) and an appearance bilateral pairwise (sx = sy = 80,
sr = sg = sb = 13, Potts 10), 5 mean-field iterations, MAP, and a colourised
PPM in which each label takes the colour of its first appearance in the
annotation (the example's getColor/putColor codec).

Two builds give the same labels: the device build
(``models/crf2d_device.py``, the default) makes both lattices on the
device; the host build (``device_build=False``) makes them with the native
builder and runs :class:`~..models.crf.DenseCRF2D`.
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np
import torch

from rovinasemanticsegmentation_tpu.utils.imageio import load_ppm, save_ppm

from ..models.crf import DenseCRF2D, PottsCompatibility
from ..models.crf2d_device import dense2d_map_from_labels_device

M = 21  # number of labels, dense_inference.cpp:33
GT_PROB = 0.5  # dense_inference.cpp:35


def _first_appearance_ids(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Label id per unique colour, in order of first appearance (:43-49).

    Returns (unique colours, per-pixel ids, per-colour ids): pure black (0)
    and any colour that first appears after M ids are taken map to -1, the
    reference's getColor bookkeeping over the unique colours.
    """
    uniq, first_idx, inverse = np.unique(
        packed, return_index=True, return_inverse=True
    )
    ids = np.full(len(uniq), -1, np.int32)
    next_id = 0
    for u in np.argsort(first_idx, kind="stable"):
        if uniq[u] == 0 or next_id >= M:
            continue
        ids[u] = next_id
        next_id += 1
    return uniq, ids[inverse], ids


def _packed_colors(anno: np.ndarray) -> np.ndarray:
    return (
        anno[..., 0].astype(np.int32)
        | (anno[..., 1].astype(np.int32) << 8)
        | (anno[..., 2].astype(np.int32) << 16)
    ).reshape(-1)


def annotation_energies() -> Tuple[float, float, float]:
    """(unknown, non-matching, matching) unary energies (:37-41)."""
    return (
        -np.log(1.0 / M),
        -np.log((1.0 - GT_PROB) / (M - 1)),
        -np.log(GT_PROB),
    )


def annotation_labels(anno: np.ndarray) -> np.ndarray:
    """Label map [N] from the annotation's packed colours (:43-49)."""
    _, labels, _ = _first_appearance_ids(_packed_colors(anno))
    return labels


def unary_from_annotation(anno: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Labels and unary energies of the annotation (:37-52).

    Colours take label ids in order of first appearance; pure black (0) is
    unknown (label -1). Returns (unary [N, M], labels [N]).
    """
    h, w = anno.shape[:2]
    labels = annotation_labels(anno)
    u_energy, n_energy, p_energy = annotation_energies()
    unary = np.full((h * w, M), u_energy, np.float32)
    known = labels >= 0
    unary[known] = n_energy
    unary[known, labels[known]] = p_energy
    return unary, labels


def colorize(map_labels: np.ndarray, anno: np.ndarray) -> np.ndarray:
    """Map labels back to their first-appearance colours (putColor)."""
    uniq, _, uniq_ids = _first_appearance_ids(_packed_colors(anno))
    palette = np.zeros((M, 3), np.uint8)
    has_id = uniq_ids >= 0
    cols = uniq[has_id]
    palette[uniq_ids[has_id]] = np.stack(
        [cols & 255, (cols >> 8) & 255, (cols >> 16) & 255], axis=1
    ).astype(np.uint8)
    return palette[map_labels]


def run(
    image_path: str,
    anno_path: str,
    out_path: str,
    iterations: int = 5,
    device_build: bool = True,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Label the image, write the colourised PPM, return the [H, W] labels."""
    im = load_ppm(image_path)
    anno = load_ppm(anno_path)
    h, w = im.shape[:2]
    labels = annotation_labels(anno)
    if device_build:
        map_labels = dense2d_map_from_labels_device(
            im, labels, annotation_energies(), M, iterations, device=device
        )
    else:
        crf = DenseCRF2D(w, h, M, device)
        crf.add_pairwise_gaussian(3, 3, PottsCompatibility(3))
        crf.add_pairwise_bilateral(
            80, 80, 13, 13, 13, im, PottsCompatibility(10)
        )
        map_labels = crf.map_from_labels(
            labels, annotation_energies(), iterations
        )
    save_ppm(out_path, colorize(map_labels, anno).reshape(h, w, 3))
    return map_labels.reshape(h, w)


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if len(args) == 5 and args[3] == "--device":
        device = args.pop(4)
        args.pop(3)
    if len(args) != 3:
        print("Usage: dense_inference <image.ppm> <annotation.ppm> "
              "<output.ppm> [--device cuda|cpu]")
        raise SystemExit(1)
    run(args[0], args[1], args[2], device=device)


if __name__ == "__main__":
    main()
