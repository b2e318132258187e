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
on a CUDA tensor it launches the kernel or raises. The package imports
neither ``jax`` nor anything of the JAX package: it keeps its own copies of
the JAX package's jax-free modules (``utils/{config,calibration,labels,
metrics,imageio}.py``, ``features/dataset.py``, ``serve/camera.py`` and
``native/``, whose C++ library builds from the port's sources into
``csrc/_build/``).

The dense CRF (``models/lattice.py``, ``models/crf.py``,
``models/crf2d_device.py``) is plain PyTorch, like its JAX counterpart,
which has no Pallas kernel. Beside the online node (``cli/node.py``) the
port has the offline entry points: the streaming step
(``pipelines/streaming.py``), the evaluation CLIs (``cli/test.py``,
``cli/test_multi.py``) and the 2D CRF demo (``cli/dense_inference.py``).
"""

__version__ = "0.1.0"
