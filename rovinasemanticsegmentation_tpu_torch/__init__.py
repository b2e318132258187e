"""ROVINA semantic segmentation on PyTorch and CUDA (NVIDIA Hopper).

A port of ``rovinasemanticsegmentation_tpu`` that keeps its subpackage
layout (``ops/``, ``models/``, ``features/``, ``fusion/``, ``pipelines/``,
``serve/``, ``cli/``), so each module's counterpart sits under the same path.
Plain tensor code is PyTorch on an explicit ``device``; the two Pallas
kernels of the keyframe path are hand-written CUDA C++ for ``sm_90a``
(``csrc/``):

- ``csrc/patches.cu`` -- depth-adaptive patch resampling
  (``ops/patches_cuda.py``);
- ``csrc/forest_descent.cu`` -- random-forest descent with the fused
  leaf-histogram sum (``ops/forest_cuda.py``).

On a CPU tensor each kernel wrapper runs the kernel's plain PyTorch version;
on a CUDA tensor it launches the kernel or raises. The package never imports
``jax``; it reuses only the reference package's jax-free modules
(``utils/config.py``, ``utils/calibration.py``, ``utils/labels.py``,
``serve/camera.py`` and ``native/``).

The map path's dense CRF (``models/lattice.py``, ``models/crf.py``) is
plain PyTorch, like its JAX counterpart, which has no Pallas kernel.
"""

__version__ = "0.1.0"
