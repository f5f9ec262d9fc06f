"""Port parity of the examples (``albatross_tpu_torch.examples``) against
the JAX package's ``examples/*.py``, on the CPU in f64.

Each test runs the JAX example's ``main()`` at tests/test_examples.py's
small arguments and the port's ``main`` with ``--device cpu``, and holds
the printed text line by line (tests/printed_numbers.py: the words equal,
each number equal at its printed digits or one unit of its last digit
apart).  Where the JAX example has helpers (sinc's ``make_data`` /
``build_model``, sparse's ``truth``), the port's ``run()`` is also held
against them at 1e-10 relative to the largest entry: the same algorithms
in f64 on both sides.  The sampler's chain comes from another random
stream, so it is held to what no stream changes; the accuracy example's
f32 numbers come from two f32 factorizations, so they are held at f32
tolerances.
"""

import csv
import importlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
from printed_numbers import assert_same_print, numbers

torch.set_num_threads(2)
torch.exp(torch.linspace(-3.0, 0.0, 4096, dtype=torch.float32))  # warm up the f32 exp
RTOL = 1e-10


def jax_main(module: str, argv: list, capsys) -> str:
    mod = importlib.import_module(module)
    old = sys.argv
    sys.argv = [module] + argv
    try:
        assert mod.main() == 0
    finally:
        sys.argv = old
    return capsys.readouterr().out


def port_main(name: str, argv: list, capsys) -> str:
    mod = importlib.import_module(f"albatross_tpu_torch.examples.{name}")
    assert mod.main(argv + ["--device", "cpu"]) == 0
    return capsys.readouterr().out


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)
    assert err <= rtol, err


@pytest.mark.parametrize("mode, tune", [("radial_only", False), ("parametric", False), ("radial", False),
                                        ("parametric", True), ("radial_only", True)])
def test_sinc_prints_what_jax_prints(mode, tune, capsys):
    argv = ["--mode", mode, "--n", "20"] + (["--tune"] if tune else [])
    assert_same_print(jax_main("examples.sinc", argv, capsys), port_main("sinc", argv, capsys))


@pytest.mark.parametrize("mode", ["radial_only", "radial", "parametric"])
def test_sinc_run_matches_the_jax_helpers(mode):
    import examples.sinc as js

    from albatross_tpu_torch.examples import sinc as ps

    n = 20
    # the radial mode's covariance has condition number 3.3e7 at n = 20
    # (the polynomial's sigma of 100), so f64 rounding reaches 7e-9 there
    rtol = 1e-8 if mode == "radial" else RTOL
    data = js.make_data(n, noise_sd=1.0)
    model = js.build_model(mode)
    pred = model.fit(data).predict(jnp.linspace(js.LOW, js.HIGH, 201)).marginal()
    out = ps.run(mode, n=n, device="cpu")
    port_data = ps.make_data(n, 1.0, device="cpu")
    close(port_data.features, data.features)
    close(port_data.targets.mean, data.targets.mean)
    close(out["mean"], pred.mean, rtol)
    close(out["variance"], pred.variance, rtol)
    close(out["nlml"], -model.log_likelihood(data), rtol)
    assert out["param_details"] == model.pretty_param_details()
    assert out["params"] == pytest.approx({k: float(p.value) for k, p in model.get_params().items()}, rel=RTOL)


def test_sinc_mean_parameters_are_discovered():
    """The user's mean subclass exposes its Parameters to the model, as
    the JAX package's module discovery does."""
    from albatross_tpu_torch.examples import sinc as ps

    names = set(ps.build_model("parametric").get_params())
    assert {"scale", "translation", "width", "slope", "offset"} <= names
    moved = ps.SincMean().set_param_value("width", 3.0)
    x = torch.linspace(-10.0, 23.0, 7, dtype=torch.float64)
    close(moved(x), 10.0 * torch.sinc((x - 5.0) / 3.0 / torch.pi))


def test_sinc_csv_matches_jax(tmp_path, capsys):
    argv = ["--mode", "radial_only", "--n", "20"]
    want = jax_main("examples.sinc", argv + ["--output", str(tmp_path / "jax.csv")], capsys)
    got = port_main("sinc", argv + ["--output", str(tmp_path / "port.csv")], capsys)
    assert_same_print(want.replace("jax.csv", "out.csv"), got.replace("port.csv", "out.csv"))
    with open(tmp_path / "jax.csv") as f:
        jax_rows = list(csv.reader(f))
    with open(tmp_path / "port.csv") as f:
        port_rows = list(csv.reader(f))
    assert port_rows[0] == jax_rows[0] and len(port_rows) == len(jax_rows) == 202
    close(np.array(port_rows[1:], float), np.array(jax_rows[1:], float))


def test_sparse_prints_what_jax_prints(capsys):
    argv = ["--n", "60", "--inducing", "8"]
    assert_same_print(jax_main("examples.sparse", argv, capsys), port_main("sparse", argv, capsys))


def test_sparse_run_matches_jax():
    import examples.sparse as js

    from albatross_tpu_torch.examples import sparse as ps

    n, m = 60, 8
    rng = np.random.default_rng(3)
    x = jnp.asarray(np.sort(rng.uniform(js.LOW, js.HIGH, n)))
    data = ab.RegressionDataset.create(x, js.truth(x) + 0.5 * jnp.asarray(rng.standard_normal(n)))
    kernel = ab.SquaredExponential(2.0, 5.0) + ab.measurement_only(ab.IndependentNoise(0.5))
    sparse = ab.sparse_gp_from_covariance(kernel, inducing_point_strategy=ab.UniformlySpacedInducingPoints(m))
    xs = jnp.linspace(js.LOW, js.HIGH, 101)
    pred = sparse.fit(data).predict(xs).marginal()
    out = ps.run(n, m, device="cpu")
    close(ps.truth(torch.as_tensor(np.array(xs))), js.truth(xs))
    close(out["sparse_mean"], pred.mean)
    close(out["sparse_variance"], pred.variance)
    close(out["exact_mean"], ab.gp_from_covariance(kernel).fit(data).predict(xs).marginal().mean)
    close(out["nlml"], -sparse.log_likelihood(data))


def test_inspection_prints_the_jax_text(capsys):
    """Call traces, parameter and prior dumps, insights and the
    eigen-direction diagnosis: the same text, line for line."""
    want = jax_main("examples.inspection", [], capsys)
    got = port_main("inspection", [], capsys)
    eigen = [i for i, line in enumerate(want.splitlines()) if line.startswith("smallest eigenvalue")]
    assert len(eigen) == 1
    # the smallest eigenvalue of the nearly singular gram is LAPACK's
    # rounding residue (~3e-16 of the largest, 2.5): both below 1e-14
    assert_same_print(want, got, noise={eigen[0]: 1e-14})
    assert [line for i, line in enumerate(got.splitlines()) if i != eigen[0]] == \
        [line for i, line in enumerate(want.splitlines()) if i != eigen[0]]


def test_sampler_matches_jax_where_no_stream_changes(tmp_path, capsys):
    """The tuned NLML at 1e-8; for the chain, which another random stream
    draws, finite log-probs, an acceptance rate in (0, 1), the CSV's header
    and row count, and the posterior medians inside the JAX chain's 90%
    interval."""
    from albatross_tpu_torch.examples import sampler as ps

    args = ["--n", "15", "--walkers", "8", "--iterations", "15", "--burn-in", "5"]
    want = jax_main("examples.sampler", args + ["--output", str(tmp_path / "jax.csv")], capsys).splitlines()
    out = ps.run(15, 8, 15, 5, str(tmp_path / "port.csv"), device="cpu")
    tuned = numbers(want[0])[0]
    assert out["tuned_nlml"] == pytest.approx(tuned, abs=5e-5)  # JAX prints 4 decimals
    assert out["tuned_nlml"] == pytest.approx(_jax_sampler_tuned_nlml(), rel=1e-8)
    assert np.isfinite(out["log_prob"]).all() and out["log_prob"].shape == (16, 8)
    assert 0.0 < out["acceptance_rate"] < 1.0
    for line, key in ((want[2], "length_scale"), (want[3], "sigma")):
        _, _, lo, hi, _ = numbers(line)  # median, 90, the interval, the truth
        assert lo <= out[key][0] <= hi, (line, out[key])
    with open(tmp_path / "jax.csv") as f:
        jax_rows = list(csv.reader(f))
    with open(tmp_path / "port.csv") as f:
        port_rows = list(csv.reader(f))
    assert port_rows[0] == jax_rows[0]
    assert len(port_rows) == len(jax_rows) == 1 + 16 * 8
    assert out["names"] == jax_rows[0][3:]


def _jax_sampler_tuned_nlml() -> float:
    """The JAX example's warm start at its test arguments (n = 15), at full
    precision (its main prints 4 decimals)."""
    from albatross_tpu.core import FixedPrior, LogScaleUniformPrior
    from albatross_tpu.evaluation import GaussianProcessNegativeLogLikelihood
    from albatross_tpu.tuning import get_tuner

    n = 15
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0.0, 20.0, n))
    K = 4.0 * np.exp(-(((x[:, None] - x[None, :]) / 3.0) ** 2)) + 0.09 * np.eye(n)
    y = np.linalg.cholesky(K + 1e-12 * np.eye(n)) @ rng.standard_normal(n)
    kernel = (ab.SquaredExponential(1.0, 1.0) + ab.measurement_only(ab.IndependentNoise(0.3))).set_param_prior(
        "squared_exponential_length_scale", LogScaleUniformPrior(1e-2, 1e3)).set_param_prior(
        "sigma_squared_exponential", LogScaleUniformPrior(1e-2, 1e3)).set_param_prior(
        "sigma_independent_noise", FixedPrior())
    data = ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y))
    _, result = get_tuner(ab.gp_from_covariance(kernel), GaussianProcessNegativeLogLikelihood(), data,
                          optimizer="lbfgs", max_iterations=60).tuned_model()
    return float(result.value)


def test_accuracy_matches_jax_at_f32_tolerances(capsys):
    """Both packages build their own f32 covariance and factor it in f32,
    so the numbers agree to f32 rounding, not digit for digit: the f64
    oracles (of two f32 covariances, a few ulp apart entrywise) within
    1e-6 relative; each mode's log-likelihood within 2e-5 relative of the
    JAX mode's (the JAX example reads its plain f32 error 6.7e-6 at
    n = 400); each mode's error against its own oracle below 2e-5."""
    from albatross_tpu_torch.examples import accuracy as pa

    want = jax_main("examples.accuracy", ["--n", "400"], capsys).splitlines()
    out = pa.run(400, device="cpu")
    assert out["oracle"] == pytest.approx(numbers(want[0])[-1], rel=1e-6)
    assert list(out["modes"]) == [line[:32].strip() for line in want[1:]]
    for line, (ll, rel) in zip(want[1:], out["modes"].values()):
        assert ll == pytest.approx(numbers(line[32:])[0], rel=2e-5), line
        assert rel < 2e-5, (line, rel)
    assert torch.get_default_dtype() == torch.float32  # the knobs and defaults left as they were
    from albatross_tpu_torch import config

    assert config.CHOLESKY_PRECISION is None and config.NLML_COMPENSATED is False


def test_accuracy_resets_the_knobs_when_a_mode_raises(monkeypatch):
    from albatross_tpu_torch import config
    from albatross_tpu_torch.examples import accuracy as pa
    from albatross_tpu_torch.models import GaussianProcess

    def boom(self, data):
        raise FloatingPointError("injected")

    monkeypatch.setattr(GaussianProcess, "log_likelihood", boom)
    with pytest.raises(FloatingPointError):
        pa.run(64, device="cpu")
    assert config.CHOLESKY_PRECISION is None and config.NLML_COMPENSATED is False


def test_temperature_is_the_ported_example():
    from albatross_tpu_torch import temperature
    from albatross_tpu_torch.examples import temperature as example

    assert example.main is temperature.main


def test_every_jax_example_has_a_port_counterpart():
    """Each of examples/*.py has a module of the same name with ``main``
    (and ``run``, but the temperature example, whose module predates the
    examples package), and ``python -m albatross_tpu_torch.examples`` runs
    them all."""
    from pathlib import Path

    from albatross_tpu_torch.examples.__main__ import EXAMPLES

    names = sorted(p.stem for p in (Path(__file__).parent.parent / "examples").glob("*.py") if p.stem != "__init__")
    assert sorted(EXAMPLES) == names
    for name in names:
        mod = importlib.import_module(f"albatross_tpu_torch.examples.{name}")
        assert callable(mod.main) and (name == "temperature" or callable(mod.run)), name


def test_examples_raise_without_a_gpu_unless_asked_for_the_cpu():
    from albatross_tpu_torch.examples import inspection

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        inspection.run()
