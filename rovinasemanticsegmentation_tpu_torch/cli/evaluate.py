"""Shared evaluation runner behind the ``test`` and ``test_multi`` CLIs.

Counterpart of ``rovinasemanticsegmentation_tpu/cli/evaluate.py``, after the
reference evaluators (``src/test.cpp:35-231``, ``src/test_multi.cpp:35-270``):
per test image, features -> forest -> stride posteriors (init -1000) ->
full-resolution resize -> argmax labels (-1 floor); write the colourised
predictions, accumulate confusion counts where prediction and ground truth
are both >= 0, and print the per-layer confusion matrix, global accuracy,
class-average accuracy, mean IoU and the time per image. The dataset
reader, the metrics, the image IO and the label codings are the JAX
package's jax-free modules.

One flag more than the JAX CLIs: ``--device`` (``cuda`` by default, or
``cpu``).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from rovinasemanticsegmentation_tpu.features.dataset import (
    RovinaDataset,
    layer_prefixes_for,
    model_path_for,
)
from rovinasemanticsegmentation_tpu.utils.config import (
    Config,
    parse_cli_overrides,
)
from rovinasemanticsegmentation_tpu.utils.imageio import save_color
from rovinasemanticsegmentation_tpu.utils.labels import RgbLabelConversion
from rovinasemanticsegmentation_tpu.utils.metrics import ConfusionAccumulator

from ..features.extractor import FeatureConfig
from ..models.forest import load_forest
from ..pipelines.single_frame import SingleFramePipeline


def config_and_device(argv: Sequence[str]) -> Tuple[Config, str]:
    """``--conf <file> [--device cuda|cpu] [--key value ...]`` -> (config
    with the overrides, device name). ``--device`` is taken out before the
    config sees the overrides."""
    params = parse_cli_overrides(argv)
    device = params.pop("device", "cuda")
    if "conf" not in params:
        raise ValueError("No config file was given (use --conf <config file>)")
    return Config(params.pop("conf"), params), device


def run_evaluation(
    conf: Config,
    multi: bool,
    write_results: bool = True,
    device: torch.device | str = "cuda",
) -> List[ConfusionAccumulator]:
    prefixes, shared = layer_prefixes_for(conf)
    if multi and not shared:
        # test_multi.cpp:57-60
        raise RuntimeError(
            "This config file doesn't use shared forests, use the single "
            "label testing!"
        )
    if not multi and shared:
        # test.cpp:57-60
        raise RuntimeError(
            "This config file uses shared forests, use the multi label "
            "testing!"
        )

    dataset = RovinaDataset(conf, "file_names_test", prefixes, load_labels=True)
    codings = {l["name"]: l["coding"] for l in conf.get_raw("color_codings")}
    converters = [RgbLabelConversion(codings[p]) for p in prefixes]
    class_counts = [c.valid_label_count for c in converters]

    forest = load_forest(model_path_for(conf), class_counts=class_counts)
    pipeline = SingleFramePipeline(
        FeatureConfig.from_config(conf),
        forest,
        stride=conf.get_int("rf_prediction_stride"),
        device=device,
        fill_value=-1000.0,  # test_multi.cpp:181
    )
    on_card = pipeline.device.type == "cuda"

    result_dirs: List[Optional[str]] = []
    result_exts: List[Optional[str]] = []
    for p in prefixes:
        if write_results:
            result_dirs.append(conf.get_path(f"{p}_result_dir"))
            result_exts.append(conf.get_str(f"{p}_result_ext"))
            os.makedirs(result_dirs[-1], exist_ok=True)
        else:
            result_dirs.append(None)
            result_exts.append(None)

    accs = [ConfusionAccumulator(c) for c in class_counts]
    time_avg = 0.0
    for sample in dataset:
        begin = time.perf_counter()
        result = pipeline.run(sample.rgb, sample.depth, sample.calibration)
        if on_card:  # the card's time, not the time to queue its work
            torch.cuda.synchronize(pipeline.device)
        labels = [l.cpu().numpy() for l in result.labels]
        time_avg += time.perf_counter() - begin
        for li in range(len(prefixes)):
            if write_results:
                rgb = converters[li].label_to_rgb(labels[li].astype(np.int8))
                save_color(
                    f"{result_dirs[li]}{sample.name}{result_exts[li]}", rgb
                )
            accs[li].update(labels[li], sample.labels[li])

    if len(dataset):
        print(f"\nTime per image: {time_avg / len(dataset)}")
    for li, acc in enumerate(accs):
        names = [converters[li].get_label_name(i) for i in range(class_counts[li])]
        print(acc.report(names))
    return accs
