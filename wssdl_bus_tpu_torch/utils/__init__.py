"""Small helpers shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is wanted and no card is present, so a run
    never drops to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return dev


def warm_cpu_vector_math() -> None:
    """Run ``exp`` and ``log`` once on the calling thread, on tensors small
    enough that no worker thread joins in.

    On a CPU build with MKL, PyTorch computes f32 ``exp``/``log`` through
    MKL's vector math (``vmsExp``/``vmsLn``, 2048 elements per call).  The
    first calls of a process, when several OpenMP workers make them at
    once, can race MKL's lazy set-up: one worker then returns a block of
    2048 values with relative errors up to 1.5e-4 (about 2^-13) instead of
    an ulp, once.  Under a loaded host this moved decoded proposal boxes
    by up to 0.03 px (``ops/boxes.py:bbox_transform_inv``).  A first call
    made serially finishes the set-up before any worker can race it; in
    repeated loaded runs no bad block appeared after it.  CUDA tensors do
    not go through MKL."""
    x = torch.full((16,), 0.5, dtype=torch.float32)
    torch.exp(x)
    torch.log(x)
