"""The training level loop's exact split search on the card: CUDA kernel
wrapper.

``csrc/split_search.cu`` takes a level's sorted stream (the int64 (segment,
value) keys of K feature slots and the sort's order, as
``train/forest_trainer.py::_split_search`` sorts them) and gives every (slot,
segment)'s best split in 6 launches: the class bytes staged, each tile's class
counts, their prefixes, the segments' bounds and class prefixes, the
entropies and segment minima, the results. It replaces no TPU kernel: the
JAX package's search is XLA ops. Its four ``[K, F]`` results are
``_split_search_plain``'s, bit for bit, and it makes nothing of size
``[K, C, Ns]``.

``_split_search`` sends every CUDA tensor here; the plain search stays the
path of every other device. On a CUDA tensor the kernels take 1 to
:data:`MAX_CLASSES` classes, up to 65535 slots and fewer than
:data:`MAX_POSITIONS` positions, and :func:`search` raises ``ValueError``
beyond them or for inputs of another type or shape: nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..csrc.build import check_launch, load_kernels
from ..utils.profiling import counter

#: searches through the kernels (one a level of the training loop)
launches = counter("split_search_cuda.launches")

#: classes the kernels take (csrc/split_search.cu's MAX_CLASSES: a lane holds
#: a class's running count)
MAX_CLASSES = 32
#: feature slots the kernels take (a grid row a slot)
MAX_SLOTS = 65535
#: sorted positions the kernels take: the last tile's int32 indices
MAX_POSITIONS = 2**31 - 1 - 1024


def _check(sorted_key, order, vals, seg, cls, class_weights, weighted,
           num_segments: int, num_classes: int, table) -> None:
    """Raise ``ValueError`` for what the kernels do not take."""
    if vals.dtype != torch.float32 or vals.dim() != 2:
        raise ValueError(f"vals must be [K, Ns] float32, got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    k, ns = vals.shape
    for name, t in (("sorted_key", sorted_key), ("order", order)):
        if t.dtype != torch.int64 or tuple(t.shape) != (k, ns):
            raise ValueError(f"{name} must be [{k}, {ns}] int64, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("seg", seg), ("cls", cls)):
        if t.dtype != torch.int64 or tuple(t.shape) != (ns,):
            raise ValueError(f"{name} must be [{ns}] int64, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not 1 <= k <= MAX_SLOTS or not 1 <= ns <= MAX_POSITIONS:
        raise ValueError(f"the kernels take 1 to {MAX_SLOTS} slots of 1 to "
                         f"{MAX_POSITIONS} positions, got [{k}, {ns}]")
    if not 1 <= num_classes <= MAX_CLASSES or num_segments < 1:
        raise ValueError(f"the kernels take 1 to {MAX_CLASSES} classes and at "
                         f"least one segment, got {num_classes} and "
                         f"{num_segments}")
    if table.dtype != torch.float32 or table.dim() != 1 or len(table) <= ns:
        raise ValueError(f"table must be float32 [> {ns}], got "
                         f"{tuple(table.shape)} {table.dtype}")
    f, c = num_segments, num_classes
    if class_weights is not None and (
            class_weights.dtype != torch.float32
            or tuple(class_weights.shape) not in ((c,), (f, c))):
        raise ValueError(f"class_weights must be float32 [{c}] or [{f}, {c}], "
                         f"got {tuple(class_weights.shape)} {class_weights.dtype}")
    if weighted is not None and (weighted.dtype != torch.bool
                                 or tuple(weighted.shape) != (f,)):
        raise ValueError(f"weighted must be bool [{f}], got "
                         f"{tuple(weighted.shape)} {weighted.dtype}")
    tensors = [sorted_key, order, vals, seg, cls, table]
    tensors += [t for t in (class_weights, weighted) if t is not None]
    if any(t.device.type != "cuda" or t.device != vals.device for t in tensors):
        raise ValueError("the kernels take tensors on one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))


def search(
    sorted_key: torch.Tensor,  # [K, Ns] int64 sorted (seg << 32) + value order
    order: torch.Tensor,  # [K, Ns] int64 the sort's indices
    vals: torch.Tensor,  # [K, Ns] float32, one row per feature slot
    seg: torch.Tensor,  # [Ns] int64 frontier slot, num_segments = inactive
    cls: torch.Tensor,  # [Ns] int64 class in [0, num_classes) where active
    class_weights: Optional[torch.Tensor],  # [C] or [F, C] float32, None = unweighted
    weighted: Optional[torch.Tensor],  # [F] bool: weights apply (None = all)
    num_segments: int,
    num_classes: int,
    table: torch.Tensor,  # [>= Ns + 1] float32 log2 of 0..Ns
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best split per (slot, segment) of the sorted stream: (objective,
    threshold, left mass, right mass), each [K, F] float32, on the inputs'
    device and stream, without a synchronisation; counts one search."""
    _check(sorted_key, order, vals, seg, cls, class_weights, weighted,
           num_segments, num_classes, table)
    k, ns = vals.shape
    f, c = num_segments, num_classes
    dev = vals.device
    sorted_key, order, vals, seg, cls, table = (
        t.contiguous() for t in (sorted_key, order, vals, seg, cls, table))
    if class_weights is not None:
        class_weights = class_weights.contiguous()
    if weighted is not None:
        weighted = weighted.contiguous()
    lib = load_kernels()
    nbytes = ctypes.c_longlong()
    check_launch("rovina_split_search_scratch", lib.rovina_split_search_scratch(
        k, ns, f, c, ctypes.addressof(nbytes)))
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    out = tuple(torch.empty((k, f), dtype=torch.float32, device=dev)
                for _ in range(4))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rovina_split_search(
            sorted_key.data_ptr(), order.data_ptr(), vals.data_ptr(),
            seg.data_ptr(), cls.data_ptr(), table.data_ptr(),
            None if class_weights is None else class_weights.data_ptr(),
            int(class_weights is not None and class_weights.dim() == 2),
            None if weighted is None else weighted.data_ptr(),
            k, ns, f, c, scratch.data_ptr(), *(t.data_ptr() for t in out),
            stream)
    check_launch("rovina_split_search", err)
    launches.add()
    return out
