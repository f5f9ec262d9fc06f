"""The blocked Cholesky's trailing update: the 3xTF32 kernel's plain
version and its routing on the CPU, the kernel itself on the GPU.

The CPU tests hold ``plain_trailing_update`` / ``_backward`` (the kernel's
arithmetic: TF32 hi/lo splits, three f32 products) against f64 ``addmm_``
at several (rows, b), and check that CPU, f64 and walker-batched inputs keep
the ``addmm_`` / ``baddbmm_`` path (on the GPU CUDA f64 and the
compensated accuracy mode too).  The tests marked ``cuda`` need an
NVIDIA GPU and nvcc and skip without one; this file imports no JAX, so on
the GPU machine run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trailing_update.py
"""

import importlib
import math

import numpy as np
import pytest
import torch

import albatross_tpu_torch as pt
from albatross_tpu_torch import _build
from albatross_tpu_torch.ops.trailing_update import (
    plain_trailing_update,
    plain_trailing_update_backward,
    tf32_split,
    trailing_update,
    trailing_update_backward,
)

# ops/__init__ re-exports a function named blocked_cholesky
bc = importlib.import_module("albatross_tpu_torch.ops.blocked_cholesky")

# (P, b): P later column panels of width b, B of P b rows; one panel, a
# b that is not a power of 2, several panels of each
SHAPES = [(1, 128), (3, 128), (2, 256), (3, 384)]


def _problem(P, b, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    B = torch.randn((P * b, b), generator=g, dtype=torch.float64) / math.sqrt(b)
    cols = [0.1 * torch.randn((P * b - i * b, b), generator=g, dtype=torch.float64) for i in range(P)]
    grads = [torch.randn((P * b - i * b, b), generator=g, dtype=torch.float64) for i in range(P)]
    return B.to(device), [c.to(device) for c in cols], [G.to(device) for G in grads]


def _addmm_forward(B, cols):
    b = B.shape[1]
    for i, C in enumerate(cols):
        C.addmm_(B[i * b:], B[i * b:(i + 1) * b].T, alpha=-1.0)


def _addmm_backward(B, grads):
    b = B.shape[1]
    gB = torch.zeros_like(B)
    for i, G in enumerate(grads):
        if G is not None:
            gB[i * b:].addmm_(G, B[i * b:(i + 1) * b], alpha=-1.0)
            gB[i * b:(i + 1) * b].addmm_(G.T, B[i * b:], alpha=-1.0)
    return gB


def _rel(got, ref):
    """Largest error over the largest reference entry, over tensors."""
    return max((g.double() - r).abs().max().item() for g, r in zip(got, ref)) / max(
        r.abs().max().item() for r in ref)


def test_tf32_split_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-12, -(1.0 + 2.0**-11), 1.0 + 2.0**-12, 3.0e-30],
                     dtype=torch.float32)
    hi, lo = tf32_split(x)
    assert hi.tolist()[:5] == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0]
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    g = torch.Generator().manual_seed(0)
    v = torch.randn(100000, generator=g) * torch.exp(4 * torch.randn(100000, generator=g))
    hi, lo = tf32_split(v)
    assert ((hi.double() + lo.double() - v.double()).abs() <= 2.0**-22 * v.double().abs()).all()


@pytest.mark.parametrize("P, b", SHAPES)
def test_plain_forward_matches_f64_addmm(P, b):
    """The kernel's arithmetic, three f32 products of TF32 splits, against
    f64 addmm_ on the same f32 inputs; within a few times f32's own
    product error (f32 addmm_ reads 1e-7 to 4e-7 here)."""
    B64, cols64, _ = _problem(P, b, seed=P * b)
    B, cols = B64.float(), [c.float() for c in cols64]
    ref = [c.double() for c in cols]
    _addmm_forward(B.double(), ref)
    f32 = [c.clone() for c in cols]
    _addmm_forward(B, f32)
    got = [c.clone() for c in cols]
    plain_trailing_update(B, got)
    assert _rel(got, ref) <= max(4 * _rel(f32, ref), 1e-6)
    assert _rel(got, ref) <= 2e-6


@pytest.mark.parametrize("P, b", SHAPES)
@pytest.mark.parametrize("missing", [None, 0, "last"])
def test_plain_backward_matches_f64_addmm(P, b, missing):
    """B's gradient, each row block from its products in 3xTF32, against f64
    addmm_ in ops/blocked_cholesky.py's order; a cotangent may be None."""
    B64, _, grads64 = _problem(P, b, seed=7 + P * b)
    B = B64.float()
    grads = [G.float() for G in grads64]
    if missing is not None:
        grads[0 if missing == 0 else P - 1] = None
    ref = _addmm_backward(B.double(), [None if G is None else G.double() for G in grads])
    f32 = _addmm_backward(B, grads)
    got = plain_trailing_update_backward(B, grads)
    if all(G is None for G in grads):  # one panel without its cotangent
        assert torch.equal(got, torch.zeros_like(B))
        return
    assert _rel([got], [ref]) <= max(4 * _rel([f32], [ref]), 1e-6)
    assert _rel([got], [ref]) <= 2e-6


@pytest.mark.parametrize("case", ["cpu_f32", "cpu_f64", "batched",
                                  pytest.param("cuda_f64", marks=pytest.mark.cuda),
                                  pytest.param("cuda_f32_compensated", marks=pytest.mark.cuda)])
def test_cpu_f64_and_batched_keep_the_library_path(case, monkeypatch):
    """_trailing_update and _TrailingUpdate.backward route by what the input
    shows: CPU tensors (f32 or f64), CUDA f64 and the walker-batched
    (W, R, b) stacks never reach the kernel's wrappers and equal addmm_ /
    baddbmm_ to the bit; nor does CUDA f32 under the compensated accuracy
    mode (config.NLML_COMPENSATED), which keeps the f32 GEMMs."""
    def refuse(*args):
        raise AssertionError("the kernel's wrapper was called")

    device = "cpu"
    if case.startswith("cuda"):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
        device = "cuda"
    if case == "cuda_f32_compensated":
        monkeypatch.setattr(pt.config, "NLML_COMPENSATED", True)
    monkeypatch.setattr(bc, "trailing_update", refuse)
    monkeypatch.setattr(bc, "trailing_update_backward", refuse)
    B, cols, grads = _problem(2, 128, seed=3, device=device)
    if case in ("cpu_f32", "cuda_f32_compensated"):
        B, cols, grads = B.float(), [c.float() for c in cols], [G.float() for G in grads]
    if case == "batched":
        B = torch.stack([B, 2 * B])
        cols = [torch.stack([c, -c]) for c in cols]
        got = [c.clone() for c in cols]
        bc._trailing_update(B, got)
        for i, (g, c) in enumerate(zip(got, cols)):
            assert torch.equal(g, torch.baddbmm(c, B[:, i * 128:], B[:, i * 128:(i + 1) * 128].mT, alpha=-1.0))
        return
    ref = [c.clone() for c in cols]
    _addmm_forward(B, ref)
    Bv = B.clone().requires_grad_(True)
    leaves = [c.clone().requires_grad_(True) for c in cols]
    outs = bc._TrailingUpdate.apply(Bv, *[c.clone() for c in leaves])
    assert all(torch.equal(o, r) for o, r in zip(outs, ref))
    torch.autograd.backward(outs, grads)
    assert torch.equal(Bv.grad, _addmm_backward(B, grads))
    assert all(torch.equal(c.grad, G) for c, G in zip(leaves, grads))


def test_the_wrappers_refuse_cpu_tensors():
    B, cols, grads = _problem(2, 128, seed=5)
    with pytest.raises(TypeError, match="CUDA f32"):
        trailing_update(B.float(), [c.float() for c in cols])
    with pytest.raises(TypeError, match="CUDA f32"):
        trailing_update_backward(B.float(), [G.float() for G in grads])


# -- on the GPU -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("P", [27, 13, 1])
def test_kernel_matches_f64_at_main_path_shapes(cuda, P):
    """b = 1024 with the main path's first, middle and last panels: forward
    and backward against f64, within 4 times cuBLAS FP32's error on the
    same inputs, and against the plain version; one launch each."""
    b = 1024
    B64, cols64, grads64 = _problem(P, b, seed=P, device=cuda)
    B, cols, grads = B64.float(), [c.float() for c in cols64], [G.float() for G in grads64]
    ref = [c.double() for c in cols]
    _addmm_forward(B.double(), ref)
    f32 = [c.clone() for c in cols]
    _addmm_forward(B, f32)
    got = [c.clone() for c in cols]
    _build.reset_launch_counts()
    trailing_update(B, got)
    gB = trailing_update_backward(B, grads)
    assert _build.LAUNCHES["trailing_update"] == 1 and _build.LAUNCHES["trailing_update_backward"] == 1
    assert sum(_build.LAUNCHES.values()) == 2
    assert _rel(got, ref) <= 4 * _rel(f32, ref)
    plain = [c.clone() for c in cols]
    plain_trailing_update(B, plain)
    assert _rel(got, [p.double() for p in plain]) <= 1e-5
    gref = _addmm_backward(B.double(), [G.double() for G in grads])
    assert _rel([gB], [gref]) <= 4 * _rel([_addmm_backward(B, grads)], [gref])
    assert _rel([gB], [plain_trailing_update_backward(B, grads).double()]) <= 1e-5


@pytest.mark.cuda
def test_kernel_is_bit_equal_across_runs(cuda):
    """Every output tile comes from one block's sums in a fixed order: no
    split-K, no atomics; a missing cotangent contributes nothing."""
    _, cols64, grads64 = _problem(6, 1024, seed=11, device=cuda)
    B = torch.randn((6 * 1024, 1024), device=cuda) / 32
    cols, grads = [c.float() for c in cols64], [G.float() for G in grads64]
    first, second = [c.clone() for c in cols], [c.clone() for c in cols]
    trailing_update(B, first)
    trailing_update(B, second)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert torch.equal(trailing_update_backward(B, grads), trailing_update_backward(B, grads))
    grads[2] = None
    got = trailing_update_backward(B, grads)
    ref = _addmm_backward(B.double(), [None if G is None else G.double() for G in grads])
    assert _rel([got], [ref]) <= 1e-5


@pytest.mark.cuda
def test_kernel_raises_on_shapes_it_does_not_take(cuda):
    B = torch.randn((512, 256), device=cuda)
    cols = [torch.randn((512 - 256 * i, 256), device=cuda) for i in range(2)]
    with pytest.raises(ValueError, match="b % 128"):
        trailing_update(torch.randn((400, 200), device=cuda), [torch.randn((400 - 200 * i, 200), device=cuda)
                                                               for i in range(2)])
    with pytest.raises(ValueError, match="b % 128"):
        trailing_update(B, cols[:1])
    with pytest.raises(ValueError, match="columns 1"):
        trailing_update(B, [cols[0], cols[0]])
    with pytest.raises(ValueError, match="contiguous"):
        trailing_update(B, [cols[0], torch.randn((256, 256), device=cuda).T])
    with pytest.raises(TypeError, match="CUDA f32"):
        trailing_update(B.double(), [c.double() for c in cols])
    # a cotangent with other strides is copied, not refused
    strided = torch.randn((256, 512), device=cuda)[:, :256]
    gB = trailing_update_backward(B, [cols[0], strided])
    assert torch.equal(gB, trailing_update_backward(B, [cols[0], strided.contiguous()]))


def _bench_gp(n, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    kernel = pt.SquaredExponential(0.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.3, assume_unique=True))
    return pt.gp_from_covariance(kernel, jitter=1e-4), x, y


def _value_grad(model, data):
    x = model.get_tunable_parameters().values.clone().requires_grad_(True)
    value = -model.set_tunable_params(x).log_likelihood(data)
    (grad,) = torch.autograd.grad(value, x)
    return value.item(), grad.double().cpu()


@pytest.mark.cuda
def test_value_grad_at_8192_within_the_benchmark_limits(cuda):
    """The benchmark's exact_se1d model at N = 8192 in f32 on the card
    against the same port in f64 on the card (whose trailing update stays
    addmm_): the value and each gradient leaf within gpbench's limits for
    exact_se1d.tune (3e-5 relative; 2.5e-3 of the leaf, or of 2^-24 of the
    value where the leaf is smaller), with every panel's trailing update on
    the kernel: 7 launches forward, 7 backward."""
    model, x, y = _bench_gp(8192, seed=19)
    _build.reset_launch_counts()
    value, grad = _value_grad(model, pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float32))
    assert _build.LAUNCHES["trailing_update"] == 7 and _build.LAUNCHES["trailing_update_backward"] == 7
    _build.reset_launch_counts()
    ref_value, ref_grad = _value_grad(model, pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float64))
    assert _build.LAUNCHES["trailing_update"] == 0 and _build.LAUNCHES["trailing_update_backward"] == 0
    assert abs(value - ref_value) / abs(ref_value) <= 3e-5
    scale = torch.clamp(ref_grad.abs(), min=2.0**-24 * abs(ref_value))
    assert ((grad - ref_grad).abs() / scale).max().item() <= 2.5e-3


@pytest.mark.cuda
def test_every_panel_of_a_value_grad_at_28672_runs_on_the_kernel(cuda):
    """28 panels of 1024: the 27 with a trailing update launch the kernel
    once forward and once backward each."""
    model, x, y = _bench_gp(28672, seed=20)
    _build.reset_launch_counts()
    value, grad = _value_grad(model, pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float32))
    assert math.isfinite(value) and torch.isfinite(grad).all()
    assert _build.LAUNCHES["trailing_update"] == 27 and _build.LAUNCHES["trailing_update_backward"] == 27
