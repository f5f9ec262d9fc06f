"""The blocked Cholesky's trailing update on the tensor cores: the CUDA
kernel, its plain version and the split it computes in.

For column panel k of the right-looking loop (ops/blocked_cholesky.py), B
is the (R, b) block of the factored panel below its diagonal block, R = P b,
and cols are the P later column panels, cols[i] of shape (R - i b, b):

    forward:   cols[i] -= B[i b:] B[i b:(i + 1) b]^T                    (every i)
    backward:  gB[I b:(I + 1) b] = -( sum_{i <= I} G_i[(I - i) b:(I - i + 1) b] B[i b:(i + 1) b]
                                      + G_I^T B[I b:] )                  (every I)

with G_i the cotangent of cols[i] (None: no contribution).  The backward is
ops/blocked_cholesky.py's two products a panel, gB[r0:] -= G_i B_blk and
gB_blk -= G_i^T B[r0:], regrouped by the rows of gB they write.

``csrc/trailing_update.cu`` computes both in 3xTF32: each f32 operand is
split into a TF32 high part and the TF32-rounded remainder
(``tf32_split``), and the products lo.hi + hi.lo + hi.hi are summed on the
tensor cores, each chunk's sums then added up in f32 registers: about f32's
accuracy, with a one-sided error of about 1e-7 of a sum of squares that
the tensor cores' truncating sums leave (the source's header says more;
ops/blocked_cholesky.py keeps the compensated accuracy mode off the
kernel for it).
One launch a panel forward (``_build.LAUNCHES["trailing_update"]``) and
one backward (``"trailing_update_backward"``); the kernel takes CUDA f32
tensors whose b and rows are multiples of 128, and raises on anything
else.  TF32 stays off for every ``torch.matmul`` (config.py).  The plain versions
(``plain_trailing_update``, ``plain_trailing_update_backward``) compute the
same split products with f32 matmuls on any device; the CPU tests and
chip_smoke.py hold the kernel against them and against f64.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_T = 128


def tf32_split(x: torch.Tensor):
    """(hi, lo) of an f32 tensor: hi = x rounded to TF32 (10 stored mantissa
    bits, to nearest with ties away from zero, as cvt.rna.tf32.f32), lo =
    x - hi rounded the same way; hi + lo keeps about 22 bits of x."""
    def rna(v):
        bits = (v.view(torch.int32) + 0x1000) & -0x2000
        return bits.view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def _split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: lo.hi + hi.lo + hi.hi of the split operands, f32."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def plain_trailing_update(B: torch.Tensor, cols) -> None:
    """The kernel's forward in plain PyTorch: cols[i] -= B[i b:] B[i b:(i + 1) b]^T
    in place, each product in 3xTF32 with f32 matmuls."""
    b = B.shape[1]
    for i, C in enumerate(cols):
        C.sub_(_split_product(B[i * b:], B[i * b:(i + 1) * b].T))


def plain_trailing_update_backward(B: torch.Tensor, grads) -> torch.Tensor:
    """The kernel's backward in plain PyTorch: gB from the cotangents of the
    columns (None: none), each row block from its products in 3xTF32."""
    b = B.shape[1]
    gB = torch.zeros_like(B)
    for I in range(B.shape[0] // b):
        rows = gB[I * b:(I + 1) * b]
        for i in range(I + 1):
            if grads[i] is not None:
                rows.sub_(_split_product(grads[i][(I - i) * b:(I - i + 1) * b], B[i * b:(i + 1) * b]))
        if grads[I] is not None:
            rows.sub_(_split_product(grads[I].T, B[I * b:]))
    return gB


def _check(B: torch.Tensor, tensors, what: str) -> None:
    if B.ndim != 2 or not B.is_cuda or B.dtype != torch.float32:
        raise TypeError(f"the trailing-update kernel takes a CUDA f32 matrix B, got {tuple(B.shape)} "
                        f"{B.dtype} on {B.device}")
    R, b = B.shape
    if b % _T != 0 or R % b != 0 or R // b != len(tensors):
        raise ValueError(f"the trailing-update kernel needs b % 128 == 0 and B of (P b, b) with P = "
                         f"{len(tensors)} {what}, got B of {tuple(B.shape)}")
    if not B.is_contiguous():
        raise ValueError("the trailing-update kernel needs a contiguous B")
    for i, C in enumerate(tensors):
        if C is None:
            continue
        if C.shape != (R - i * b, b) or C.dtype != B.dtype or C.device != B.device:
            raise ValueError(f"the trailing-update kernel needs {what} {i} of {(R - i * b, b)} {B.dtype} on "
                             f"{B.device}, got {tuple(C.shape)} {C.dtype} on {C.device}")


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[0 if t is None else t.data_ptr() for t in tensors])


def trailing_update(B: torch.Tensor, cols) -> None:
    """cols[i] -= B[i b:] B[i b:(i + 1) b]^T in place for every i, in one
    launch of the kernel; CUDA f32, b and R multiples of 128, contiguous
    columns, else it raises."""
    _check(B, cols, "columns")
    if any(C.data_ptr() % 16 or not C.is_contiguous() for C in cols):
        raise ValueError("the trailing-update kernel updates contiguous, 16-byte aligned columns in place")
    lib = _build.load("trailing_update")
    fn = lib.trailing_update_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(B.device).cuda_stream
    code = fn(B.data_ptr(), _pointers(cols), len(cols), B.shape[1], stream)
    _build.count_launch("trailing_update")
    _build.check(lib, code, "trailing_update kernel")


def trailing_update_backward(B: torch.Tensor, grads) -> torch.Tensor:
    """gB from the cotangents of the columns (None: none) in one launch of
    the kernel, which writes every entry; CUDA f32, else it raises."""
    # autograd may hand over any strides: a copy for those the kernel cannot read in place
    grads = [G if G is None or (G.is_contiguous() and G.data_ptr() % 16 == 0)
             else G.clone(memory_format=torch.contiguous_format) for G in grads]
    _check(B, grads, "cotangents")
    gB = torch.empty_like(B)
    lib = _build.load("trailing_update")
    fn = lib.trailing_update_backward_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(B.device).cuda_stream
    code = fn(B.data_ptr(), _pointers(grads), gB.data_ptr(), len(grads), B.shape[1], stream)
    _build.count_launch("trailing_update_backward")
    _build.check(lib, code, "trailing_update_backward kernel")
    return gB
