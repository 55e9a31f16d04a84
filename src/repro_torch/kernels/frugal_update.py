"""The dense program kernel's wrapper and its plain PyTorch version.

``frugal_program_dense`` runs a [T, G] item block through any registered
lane program with the state in its serialized words (core.program
``StateLayout.pack_planes``). On CUDA tensors it launches the hand-written
kernel of ``csrc/frugal_update.cu`` or raises; on CPU tensors it runs
``frugal_program_dense_reference``, the plain version. It replaces the JAX
package's ``frugal_program_pallas_dma`` (B1), ``frugal_program_pallas``
(B2, as launches of ``block_t`` rows) and ``frugal_program_pallas_gpu``
(B4).

``launch_count`` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import frugal
from repro_torch.core import rng as crng

# Kernel instantiation per kernel family (FtFamily in csrc/frugal_tick.cuh).
FAMILY_IDS = {"1u": 0, "2u": 1, "2u-decay": 2, "1u-window": 3,
              "2u-window": 4}

launch_count = 0


def _scalar_slots(program, scalars):
    vals = tuple(int(s) for s in (program.scalar_values() if scalars is None
                                  else scalars))
    if len(vals) != len(program.layout.scalar_names):
        raise ValueError(f"{program.family}: {len(vals)} scalar operand(s), "
                         f"layout declares {program.layout.scalar_names}")
    return vals


def _check_operands(program, items, words, quantile, lanes_per_group):
    layout = program.layout
    if items.dim() != 2 or items.dtype != torch.float32:
        raise ValueError(f"items must be [T, G] float32, got "
                         f"{tuple(items.shape)} {items.dtype}")
    lanes = items.shape[1] * lanes_per_group
    if len(words) != layout.num_words:
        raise ValueError(f"{program.family}: {len(words)} state words, "
                         f"layout has {layout.num_words}")
    for w, dt in zip(words, layout.word_dtypes):
        if w.dtype != dt or tuple(w.shape) != (lanes,):
            raise ValueError(f"state word {tuple(w.shape)} {w.dtype} != "
                             f"[{lanes}] {dt}")
    if quantile.dtype != torch.float32 or tuple(quantile.shape) != (lanes,):
        raise ValueError(f"quantile must be [{lanes}] float32, got "
                         f"{tuple(quantile.shape)} {quantile.dtype}")
    for x in (*words, quantile):
        if x.device != items.device:
            raise ValueError(f"operands on {x.device} and {items.device}; "
                             "move them to one device")


def frugal_program_dense_reference(program, items, words, quantile, seed,
                                   scalars=None, *, t_offset=0, g_offset=0,
                                   lanes_per_group=1):
    """Plain PyTorch version of the kernel: unpack the words, run
    ``core.frugal.program_process_seeded``, repack. Same operands and
    result as ``frugal_program_dense``, on any device."""
    _check_operands(program, items, words, quantile, lanes_per_group)
    layout = program.layout
    planes, _ = frugal.program_process_seeded(
        program, layout.unpack_words(words), items, seed, quantile,
        scalars=_scalar_slots(program, scalars), t_offset=t_offset,
        g_offset=g_offset, lanes_per_group=lanes_per_group)
    return layout.pack_planes(planes)


def frugal_program_dense(program, items, words, quantile, seed,
                         scalars=None, *, t_offset=0, g_offset=0,
                         lanes_per_group=1, block_g=256):
    """Ingest ``items`` [T, G] into the state ``words`` (each [G·Q]) with
    one kernel launch; returns new word tensors.

    Lane l reads item column ``l // lanes_per_group``; its uniform at row i
    is ``counter_uniform(seed, t_offset + i, g_offset + l)``. ``block_g``
    is the CUDA block size (a multiple of 32, at most 1024). CPU tensors
    run the plain version; CUDA tensors launch the kernel or raise.
    """
    global launch_count
    if items.device.type == "cpu":
        return frugal_program_dense_reference(
            program, items, words, quantile, seed, scalars,
            t_offset=t_offset, g_offset=g_offset,
            lanes_per_group=lanes_per_group)
    if items.device.type != "cuda":
        raise ValueError(f"no dense kernel for device {items.device}")
    _check_operands(program, items, words, quantile, lanes_per_group)
    family = program.kernel_family
    if family not in FAMILY_IDS:
        raise ValueError(f"no kernel instantiation for program family "
                         f"{family!r}; kernel families: {tuple(FAMILY_IDS)}")
    if block_g <= 0 or block_g > 1024 or block_g % 32:
        raise ValueError(f"block_g must be a multiple of 32 in [32, 1024], "
                         f"got {block_g}")
    for x in (items, *words, quantile):
        if not x.is_contiguous():
            raise ValueError("the dense kernel takes contiguous tensors")
    t_len, g = items.shape
    outs = tuple(torch.empty_like(w) for w in words)
    if t_len == 0:
        for o, w in zip(outs, words):
            o.copy_(w)
        return outs
    slots = _scalar_slots(program, scalars) + (0, 0)
    ptr_in = [w.data_ptr() for w in words] + [None] * (4 - len(words))
    ptr_out = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    from .build import load_library

    with torch.cuda.device(items.device):
        stream = torch.cuda.current_stream(items.device).cuda_stream
        err = load_library().frugal_dense_launch(
            FAMILY_IDS[family], items.data_ptr(), quantile.data_ptr(),
            *ptr_in, *ptr_out, t_len, g, lanes_per_group,
            crng.wrap_i32(seed), crng.wrap_i32(t_offset),
            crng.wrap_i32(g_offset), slots[0], slots[1], block_g, stream)
    if err != 0:
        raise RuntimeError(f"frugal_dense_launch failed: cudaError_t {err}")
    launch_count += 1
    return outs
