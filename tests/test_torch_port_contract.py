"""Contract of the PyTorch port: no JAX, no silent CPU, counted launches."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import albatross_tpu_torch as pt
from albatross_tpu_torch import _build, config
from albatross_tpu_torch.convert import params_from_numpy

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


def test_import_leaves_jax_out():
    """Every module of the port, found by walking the package (so a module
    that no __init__ imports is checked too), the examples and tutorials
    included, loads neither JAX nor any module of the JAX package, its
    top-level ``examples`` and ``tutorials`` included."""
    code = (
        "import importlib, pkgutil, sys, albatross_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(albatross_tpu_torch.__path__, 'albatross_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'albatross_tpu_torch.models.ransac', 'albatross_tpu_torch.samplers.ensemble',\n"
        "        'albatross_tpu_torch.serialize.checkpoint', 'albatross_tpu_torch._native',\n"
        "        'albatross_tpu_torch.examples.distributed', 'albatross_tpu_torch.examples.__main__',\n"
        "        'albatross_tpu_torch.tutorials.tutorial_5_evaluating_uncertainty'} <= set(names), names\n"
        "assert len(names) > 95, names\n"
        "bad = [m for m in sys.modules if m in ('jax', 'examples', 'tutorials')\n"
        "       or m.startswith(('jax.', 'albatross_tpu.', 'examples.', 'tutorials.'))]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("package", ["core", "evaluation", "tuning", "indexing", "kernels", "stats", "models",
                                     "samplers", "serialize", "utils", "ops"])
def test_every_jax_name_has_a_counterpart(package):
    """Each name a ported package of the JAX package exports exists in the
    port's package of the same path."""
    import albatross_tpu

    exported = getattr(albatross_tpu, package).__all__
    missing = [name for name in exported if not hasattr(getattr(pt, package), name)]
    assert not missing, missing


# The JAX package's config knobs that pick between XLA and a Pallas kernel
# or a bf16 product scheme on the TPU; the port always runs its
# hand-written kernels with full f32 products (config's docstring).
TPU_ONLY_CONFIG = {"USE_PALLAS_GRAM", "PALLAS_GRAM_MIN_ELEMENTS", "PALLAS_GRAM_AUTO_MIN_D", "pallas_gram_enabled",
                   "PANEL_FACTORIZER", "DW_DOT_ALGORITHM", "CHOLESKY_TRAILING_BF16"}
# parallel's names still to port: none since the 2-D tile layout and the
# distributed sparse GP landed
PENDING_PARALLEL: set = set()


def test_config_has_every_knob_but_the_tpu_only_ones():
    import types

    import albatross_tpu

    names = {n for n in dir(albatross_tpu.config) if not n.startswith("_")
             and not isinstance(getattr(albatross_tpu.config, n), types.ModuleType)}
    missing = {n for n in names if not hasattr(config, n)}
    assert missing == TPU_ONLY_CONFIG, missing
    assert not any(hasattr(config, n) for n in TPU_ONLY_CONFIG)


def test_parallel_has_the_1d_names_and_only_the_2d_and_sparse_ones_pending():
    """The port's ``parallel`` has every name of the JAX package's: the 1-D
    row layout, the 2-D tile layout and the distributed sparse GP."""
    import albatross_tpu

    missing = {n for n in albatross_tpu.parallel.__all__ if not hasattr(pt.parallel, n)}
    assert missing == PENDING_PARALLEL, missing ^ PENDING_PARALLEL
    assert not PENDING_PARALLEL


# Operators a class may define, compared beside its public members.
OPERATORS = {"__add__", "__sub__", "__mul__", "__rmul__", "__matmul__", "__rmatmul__", "__neg__",
             "__getitem__", "__len__"}
# Members of the JAX classes that the port leaves out on purpose, each with
# its reason.
NOT_PORTED_MEMBERS = {
    "tree_flatten": "the pytree protocol; the port reaches gradients through set_tunable_params "
                    "and autograd (ROADMAP 'Not to port')",
    "tree_unflatten": "the other half of the pytree protocol, as above",
}
MEMBER_PACKAGES = ["core", "evaluation", "tuning", "indexing", "kernels", "stats", "models", "samplers",
                   "serialize", "utils", "ops", "parallel"]


def _members(cls) -> set:
    return {m for m in dir(cls) if not m.startswith("_") or m in OPERATORS} - set(NOT_PORTED_MEMBERS)


@pytest.mark.parametrize("package", MEMBER_PACKAGES)
def test_every_jax_class_member_has_a_counterpart(package):
    """Each class a package of the JAX package exports has, in the port's
    class of the same name, every public member (methods, properties,
    fields) and every operator of the JAX class, less the pytree protocol."""
    import inspect

    import albatross_tpu

    jax_pkg, port_pkg = getattr(albatross_tpu, package), getattr(pt, package)
    classes = [(n, getattr(jax_pkg, n)) for n in jax_pkg.__all__ if inspect.isclass(getattr(jax_pkg, n))]
    missing = {}
    for name, jcls in classes:
        tcls = getattr(port_pkg, name)
        assert inspect.isclass(tcls), name
        gap = sorted(_members(jcls) - _members(tcls))
        if gap:
            missing[name] = gap
    assert not missing, missing


def test_f32_matmul_precision_is_highest():
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        config.device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        pt.RegressionDataset.create(np.zeros(3), np.zeros(3), device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        config.device(None)
    with pytest.raises(RuntimeError, match="is_available"):
        pt.RegressionDataset.create(np.zeros(3), np.zeros(3))  # numpy data goes to the card
    assert pt.RegressionDataset.create(torch.zeros(3), np.zeros(3)).targets.mean.device.type == "cpu"
    assert config.device("cpu") == torch.device("cpu")


def test_cpu_tensors_never_launch_kernels():
    _build.reset_launch_counts()
    rng = np.random.default_rng(0)
    n = 2304  # blocked factorization with several panels
    x = np.sort(rng.uniform(0, 100, n)).astype(np.float32)
    y = np.sin(0.3 * x).astype(np.float32)
    kernel = pt.SquaredExponential(0.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.3, assume_unique=True))
    model = pt.gp_from_covariance(kernel, jitter=1e-4)
    data = pt.RegressionDataset.create(x, y, device="cpu")
    ll = model.log_likelihood(data)
    pred = model.fit(data).predict(torch.linspace(0, 100, 50)).marginal()
    assert torch.isfinite(ll) and torch.isfinite(pred.variance).all()
    assert ll.dtype == torch.float32
    assert _build.LAUNCHES == {"radial_gram": 0, "radial_gram_diag": 0, "radial_gram_cols": 0,
                               "radial_gram_diag_batched": 0, "radial_gram_highd": 0, "radial_gram_diag_highd": 0,
                               "radial_gram_cols_highd": 0, "radial_gram_diag_batched_highd": 0,
                               "radial_gram_d2_highd": 0, "panel_cholinv": 0, "panel_cholinv_batched": 0,
                               "trailing_update": 0, "trailing_update_backward": 0, "whiten_sumsq": 0}


def test_params_from_numpy():
    model = pt.gp_from_covariance(pt.SquaredExponential() + pt.IndependentNoise())
    moved = params_from_numpy(model, {"squared_exponential_length_scale": np.asarray(2.5),
                                      "sigma_independent_noise": np.float64(0.4)})
    assert moved.get_param_value("squared_exponential_length_scale") == 2.5
    assert moved.get_param_value("sigma_independent_noise") == 0.4
    assert model.get_param_value("squared_exponential_length_scale") == 100000.0  # untouched
    with pytest.raises(KeyError, match="matern_32_length_scale"):
        params_from_numpy(model, {"matern_32_length_scale": np.asarray(1.0)})
    with pytest.raises(ValueError, match="scalar"):
        params_from_numpy(model, {"sigma_independent_noise": np.ones(2)})
