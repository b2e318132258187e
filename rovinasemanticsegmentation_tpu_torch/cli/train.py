"""Training CLI (parity with semantic_segmentation_train).

Usage: python -m rovinasemanticsegmentation_tpu_torch.cli.train \
           --conf <config file> [--device cuda|cpu] [--key value ...]

Counterpart of ``rovinasemanticsegmentation_tpu/cli/train.py``, after
``src/train.cpp:35-254``: load the train split, augment each image with
brightness shifts {-20, 0, +20} x horizontal flip, extract
WITH_POSITIVE_LABEL features at ``training_sample_stride``, print the
per-layer label frequency, train the (multi-label) forest and write it in
the reference ``forest.dat`` format. Extraction (kernel A on the card) and
training run on ``--device``; the features stay there from extraction to
the trainer.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..features.dataset import (
    DatasetSample,
    RovinaDataset,
    layer_prefixes_for,
    model_path_for,
)
from ..features.extractor import (
    ExtractType,
    FeatureConfig,
    FeatureExtractor,
    to_device_depth,
    to_device_image,
)
from ..models.forest import save_forest
from ..ops.color import adjust_brightness, hflip
from ..train.forest_trainer import ForestTrainer, TrainerConfig
from ..utils.config import Config
from ..utils.labels import RgbLabelConversion
from ..utils.profiling import counter, span
from .evaluate import config_and_device

BRIGHTNESS = (-20, 0, 20)  # train.cpp:115-117
train_rows = counter("train.rows")


def extract_training_data(
    conf: Config, device: torch.device | str = "cuda", verbose: bool = True
):
    """Augmented feature extraction (train.cpp:105-223) of the train split:
    :func:`extract_training_rows` over the dataset. -> (features [N, D]
    float32 on ``device``, labels [N, L] int32 numpy, class counts, whether
    the layers share one forest)."""
    prefixes, shared = layer_prefixes_for(conf)
    dataset = RovinaDataset(conf, "file_names_train", prefixes, load_labels=True)
    codings = {l["name"]: l["coding"] for l in conf.get_raw("color_codings")}
    class_counts = [RgbLabelConversion(codings[p]).valid_label_count
                    for p in prefixes]
    extractor = FeatureExtractor(FeatureConfig.from_config(conf),
                                 resolve_device(device))
    x, y = extract_training_rows(dataset, extractor,
                                 conf.get_int("training_sample_stride"), verbose)
    if verbose:
        print(f"\n{len(x)}")
        for l in range(y.shape[1]):  # label frequency print (train.cpp:150-163)
            vals, counts = np.unique(y[:, l], return_counts=True)
            for v, cnt in zip(vals, counts):
                print(f"{v}->{cnt}")
    return x, y, class_counts, shared


def extract_training_rows(
    samples: Iterable[DatasetSample], extractor: FeatureExtractor, stride: int,
    verbose: bool = False,
) -> Tuple[torch.Tensor, np.ndarray]:
    """The labelled training rows of in-memory samples (train.cpp:105-149):
    each image brightness-shifted by -20, 0 and +20, each shift with and
    without a horizontal flip, WITH_POSITIVE_LABEL features at ``stride`` on
    the extractor's device. -> (features [N, D] float32 on that device,
    labels [N, L] int32 numpy), the variants' rows in that order.

    With tracing on, each image is a ``train.extract`` span (``attrs``:
    variants, rows); ``train.rows`` adds the rows."""
    dev = extractor.device
    feats: List[torch.Tensor] = []
    labels: List[torch.Tensor] = []
    for sample in samples:
        attrs = {"variants": 2 * len(BRIGHTNESS), "rows": 0}
        with span("train.extract", attrs=attrs):
            depth = to_device_depth(sample.depth, dev)
            for delta in BRIGHTNESS:
                rgb = adjust_brightness(to_device_image(sample.rgb, dev), delta)
                # Horizontal flip augmentation (train.cpp:132-145).
                variants = [
                    (rgb, depth, sample.labels),
                    (hflip(rgb), hflip(depth),
                     [np.ascontiguousarray(l[:, ::-1]) for l in sample.labels]),
                ]
                for v_rgb, v_depth, v_labels in variants:
                    batch = extractor.extract(
                        v_rgb, v_depth, sample.calibration, stride,
                        label_extraction=ExtractType.WITH_POSITIVE_LABEL,
                        labels=v_labels,
                    )
                    feats.append(batch.features[batch.mask])
                    labels.append(batch.labels[batch.mask])
                    attrs["rows"] += len(feats[-1])
            train_rows.add(attrs["rows"])
        if verbose:
            print("x+", end="", flush=True)
    return torch.cat(feats), torch.cat(labels).cpu().numpy().astype(np.int32)


def main(argv=None) -> None:
    conf, device = config_and_device(sys.argv[1:] if argv is None else argv)
    x, y, class_counts, shared = extract_training_data(conf, device)
    trainer = ForestTrainer(TrainerConfig.from_config(conf), device)
    forest = trainer.learn(x, y, class_counts=class_counts, multi_label=shared)
    model_file = model_path_for(conf)
    save_forest(model_file, forest)
    print(f"Wrote forest to {model_file}")


if __name__ == "__main__":
    main()
