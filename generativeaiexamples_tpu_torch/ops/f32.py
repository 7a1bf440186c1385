"""f32 products at IEEE f32 precision or better, whatever the process's
TF32 settings (the f32 models: the speech models, the ViT's attention).

cuBLAS and cuDNN run f32 products in TF32 when the process allows it
(``torch.backends.cuda.matmul.allow_tf32``, ``torch.backends.cudnn.
allow_tf32``, ``torch.set_float32_matmul_precision``), and those switches
are process-wide: setting them around a call would change every other
thread's products meanwhile.  So on the card these functions multiply in
f64 (the H100's FP64 tensor cores) and round the result to f32 once:
never TF32, scoped to the call, and no global flag is read or written.
Elsewhere they are the plain f32 operations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _wide(t: torch.Tensor) -> bool:
    return t.is_cuda and t.dtype == torch.float32


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _wide(a):
        return torch.matmul(a.double(), b.double()).float()
    return torch.matmul(a, b)


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    if _wide(operands[0]):
        return torch.einsum(equation, *(o.double() for o in operands)).float()
    return torch.einsum(equation, *operands)


def conv1d(x: torch.Tensor, w: torch.Tensor, bias=None, **kw) -> torch.Tensor:
    """``F.conv1d`` on (b, c_in, t) with (c_out, c_in / groups, k)."""
    if _wide(x):
        return F.conv1d(x.double(), w.double(), None if bias is None else bias.double(), **kw).float()
    return F.conv1d(x, w, bias, **kw)
