"""A frame's posterior maps in one launch: CUDA kernel wrapper.

``csrc/resize_argmax.cu`` computes ``pipelines/single_frame.py``'s
``posterior_maps_plain`` in one launch a frame: the masked fill, the bilinear
resize of every layer to full resolution (``ops/resize.py``'s float path) and
the argmax with the -1000 floor, bit for bit as the plain version computes
them on the card. It replaces no TPU kernel: the JAX package resizes and
takes the argmax with XLA ops. ``posterior_maps`` sends every CUDA tensor
here (:func:`engages`) and keeps the plain version for CPU tensors; what the
kernel cannot take on the card (other than float32, more than
:data:`MAX_LAYERS` layers or :data:`MAX_CLASSES` classes, a grid larger than
the frame) raises ``ValueError`` in :func:`launcher` rather than running the
plain version there.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Sequence, Tuple

import torch

from ..csrc.build import check_launch, load_kernels
from ..utils.profiling import counter

launches = counter("resize_argmax_cuda.launches")

# csrc/resize_argmax.cu's MAX_LAYERS and MAX_CLASSES: the kernel's Layers
# argument holds MAX_LAYERS pointers a kind (the forests have two layers), and
# an int8 label holds the class.
MAX_LAYERS = 2
MAX_CLASSES = 32


def engages(post) -> bool:
    """Whether ``posterior_maps`` sends ``post`` to the kernel: a tensor on a
    CUDA device."""
    return post.device.type == "cuda"


def launcher(
    post: torch.Tensor,  # [P, L, C_max] float32 on the card
    mask: torch.Tensor,  # [P] bool
    grid_shape: Tuple[int, int],
    class_counts: Sequence[int],
    fill_value: float,
    out_h: int,
    out_w: int,
) -> Tuple[Callable[[], None], List[torch.Tensor], List[torch.Tensor]]:
    """The kernel on a CUDA tensor, split in two: allocate the outputs now,
    and return the function that launches the kernel (and counts the frame)
    -> (launch, per layer ``[H, W, C_l]`` float32 posteriors, per layer
    ``[H, W]`` int8 labels), so that the launch alone can be timed. Raises
    ``ValueError`` for what the kernel does not take; the shapes are checked
    before the device."""
    gh, gw = grid_shape
    p = gh * gw
    if post.dtype != torch.float32 or post.dim() != 3 or post.shape[0] != p:
        raise ValueError(
            f"post must be float32 [{p}, L, C] for grid {tuple(grid_shape)}; "
            f"got {post.dtype} {tuple(post.shape)}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (p,):
        raise ValueError(f"mask must be bool [{p}]; got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if not (1 <= len(class_counts) <= min(MAX_LAYERS, post.shape[1])
            and all(1 <= c <= min(MAX_CLASSES, post.shape[2])
                    for c in class_counts)):
        raise ValueError(
            f"the kernel takes 1 to {MAX_LAYERS} layers of 1 to {MAX_CLASSES} "
            f"classes that post holds; got classes {tuple(class_counts)} for "
            f"post {tuple(post.shape)}")
    if not (1 <= gh <= out_h <= 65535 and 1 <= gw <= out_w):
        raise ValueError(
            f"the kernel takes a grid of at least one point no larger than "
            f"the frame, and at most 65535 rows; got grid {tuple(grid_shape)}, "
            f"frame {out_h}x{out_w}")
    if post.numel() >= 2**31 or out_h * out_w * max(class_counts) >= 2**31:
        raise ValueError("the kernel's int32 offsets need fewer than 2^31 "
                         "values in and out")
    if post.device.type != "cuda" or mask.device != post.device:
        raise ValueError(f"the kernel takes post and mask on one CUDA device; "
                         f"got {post.device} and {mask.device}")
    post = post.contiguous()
    mask = mask.contiguous()
    dev = post.device
    layers = len(class_counts)
    posteriors = [torch.empty((out_h, out_w, c), dtype=torch.float32,
                              device=dev) for c in class_counts]
    labels = [torch.empty((out_h, out_w), dtype=torch.int8, device=dev)
              for _ in class_counts]
    classes = (ctypes.c_int * layers)(*class_counts)
    rec, cmax = post.shape[1] * post.shape[2], post.shape[2]
    lib = load_kernels()

    def launch() -> None:
        # The pointer arrays are made here, so that the closure holds the
        # output tensors for as long as the launch can be called.
        outs = (ctypes.c_void_p * layers)(*(x.data_ptr() for x in posteriors))
        label_ptrs = (ctypes.c_void_p * layers)(
            *(x.data_ptr() for x in labels))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            # The scales and the fill as float32 roundings of the Python
            # floats, as torch.tensor(src / dst, dtype=float32) and
            # torch.full((), fill_value, dtype=float32) round them.
            err = lib.rovina_resize_argmax(
                post.data_ptr(), mask.data_ptr(), gh, gw, rec, cmax, layers,
                classes, float(fill_value), out_h, out_w, gh / out_h,
                gw / out_w, outs, label_ptrs, stream,
            )
        check_launch("rovina_resize_argmax", err)
        launches.add()

    return launch, posteriors, labels


def posterior_maps(
    post: torch.Tensor, mask: torch.Tensor, grid_shape: Tuple[int, int],
    class_counts: Sequence[int], fill_value: float, out_h: int, out_w: int,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``posterior_maps_plain`` in one kernel launch."""
    launch, posteriors, labels = launcher(post, mask, grid_shape, class_counts,
                                          fill_value, out_h, out_w)
    launch()
    return posteriors, labels
