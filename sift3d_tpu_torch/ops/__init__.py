"""PyTorch wrappers of the CUDA kernels, each beside its plain version."""

import functools

import torch


def warm_cpu_math(device) -> None:
    """Run torch's CPU exp and sqrt once on every intra-op thread before a
    plain version uses them; nothing on another device.

    On the CPU torch computes exp and sqrt of a float tensor with MKL's
    vector math functions, split over its OpenMP threads. In a process
    that has imported jax, one thread's share of the first such call can
    come out up to 1.5e-4 off in relative terms (torch 2.13 with MKL
    2024.2, 8 threads: 5 of 24 fresh processes, tools/torch_cpu_exp_check.py);
    every later call is accurate to an ulp."""
    if torch.device(device).type == "cpu":
        _warm(torch.get_num_threads())


@functools.cache
def _warm(threads: int) -> None:
    x = torch.linspace(0.0, 8.0, threads * 65536)   # a share for each thread
    torch.exp(-x)
    torch.sqrt(x)


def true_div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s rounded once, as the kernels, the CPU and the JAX package
    divide: torch on CUDA divides a tensor by a Python scalar as a multiply
    by the scalar's f32 reciprocal, which can be an ulp off the quotient
    and move a voxel across a window's edge in a plain version on the card.
    A tensor divisor takes the true division on every device."""
    return a / torch.full_like(a, float(s))
