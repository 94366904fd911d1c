"""Card checks of the GRU forwards' bf16-gate step (``csrc/gates16.cuh``).

The step runs its sums and products as packed bf16x2 instructions and its
exponential and reciprocal on the SFU, and is meant to give the bits of
the accurate forms it replaced (every operation in float32, then rounded
to bf16; IEEE ``expf`` and division). ``csrc/gates16_check.cu`` keeps those
forms and runs both side by side: ``check_unary`` on bf16 inputs of the
sigmoid and the typed tanh, ``check_step`` on operand sets of the step.
No model path calls them; they take CUDA tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _on_card(*ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("the gate checks take contiguous CUDA tensors")


def all_bf16() -> torch.Tensor:
    """Every bf16 bit pattern, 0 to 65,535 in order, as int16 on the
    card."""
    a = torch.arange(65536, dtype=torch.int32, device="cuda")
    return torch.where(a >= 32768, a - 65536, a).to(torch.int16)


def check_unary(x: torch.Tensor):
    """x: bf16 bit patterns (int16) on the card. Returns (out [n, 4] int16:
    the new sigmoid, the accurate one, the new typed tanh, the accurate
    one, as bf16 bits; slow [n, 2] uint8: 1 where the exponential of the
    sigmoid (column 0) or of the tanh's sigmoid(2x) (column 1) takes
    ``expf``; ulps [n, 2] float32: the SFU exponential's distance from
    the float64 exp in float32 ulps, -1 where that is not a normal
    float32)."""
    _on_card(x)
    if x.dtype != torch.int16:
        raise ValueError("check_unary takes bf16 bit patterns as int16")
    n = x.numel()
    out = torch.empty((n, 4), dtype=torch.int16, device=x.device)
    slow = torch.empty((n, 2), dtype=torch.uint8, device=x.device)
    ulps = torch.empty((n, 2), dtype=torch.float32, device=x.device)
    fn = _build.load("gates16_check").gates16_check_unary
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    _build.check_status(fn(x.data_ptr(), n, out.data_ptr(), slow.data_ptr(),
                           ulps.data_ptr(), _stream()), "gates16_check_unary")
    return out, slow, ulps


def check_step(sums: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    """sums [n, 6] float32 (the input projection's sums with their bias
    for r, z, n, then the recurrent product's sums), bf [n, 4] bf16 bit
    patterns as int16 (the recurrent biases of r, z, n, then the state);
    rows 2k and 2k + 1 are one packed pair. Returns [n, 2] int16: the new
    step's state and the accurate step's, as bf16 bits."""
    _on_card(sums, bf)
    n = sums.shape[0]
    if (sums.dtype != torch.float32 or bf.dtype != torch.int16
            or sums.shape != (n, 6) or bf.shape != (n, 4) or n % 2):
        raise ValueError("check_step takes sums [n, 6] float32 and bf "
                         "[n, 4] int16, n even")
    out = torch.empty((n, 2), dtype=torch.int16, device=sums.device)
    fn = _build.load("gates16_check").gates16_check_step
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    _build.check_status(fn(sums.data_ptr(), bf.data_ptr(), n,
                           out.data_ptr(), _stream()), "gates16_check_step")
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Where two bf16 bit patterns (int16) agree: equal bits, or both a
    NaN (the two forms may give NaNs of different sign or payload)."""
    nan = lambda t: ((t.int() & 0x7F80) == 0x7F80) & ((t.int() & 0x7F) != 0)
    return (a == b) | (nan(a) & nan(b))
