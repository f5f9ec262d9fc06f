"""Port parity of utils/ and _native/: Chebyshev bases, graphs, CSV I/O,
the native parser and MST, random draws, profiling.

The same inputs go through the JAX package's function and the port's, at
f64: Chebyshev values to 1e-12; spanning trees and forests edge for edge;
CSV text character for character; the native library's columns and masks
exactly.  Given the JAX package's draws, MVN samples match to 1e-12 and
random covariance matrices to 1e-10 (each package's QR of the normals).
"""

import io
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu import _native as jnative
from albatross_tpu import utils as ju
from albatross_tpu_torch import _native as tnative
from albatross_tpu_torch import utils as tu

torch.set_num_threads(2)
# PyTorch's CPU f32 exp can return ~1e-4-wrong values on its first
# multi-threaded call; one warm-up call takes that call out of the tests.
torch.exp(torch.zeros(1 << 16))
TOL = 1e-12


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_chebyshev_matches_jax(n):
    x = np.linspace(-1.2, 1.2, 13)
    np.testing.assert_allclose(tu.chebyshev_t(n, torch.as_tensor(x)).numpy(),
                               np.asarray(ju.chebyshev_t(n, jnp.asarray(x))), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tu.chebyshev_u(n, x).numpy(), np.asarray(ju.chebyshev_u(n, jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    phi = tu.chebyshev_t_phi(torch.linspace(0, 4, 7, dtype=torch.float64), order=n + 1, lo=0.0, hi=4.0)
    ref = ju.chebyshev_t_phi(jnp.linspace(0, 4, 7), order=n + 1, lo=0.0, hi=4.0)
    assert phi.shape == (7, n + 1)
    np.testing.assert_allclose(phi.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def _random_graph(module, seed, n_v=20, n_e=60):
    rng = np.random.default_rng(seed)
    g = module.Graph()
    for _ in range(n_e):
        a, b = rng.integers(0, n_v, 2)
        g.add_edge(int(a), int(b), float(rng.integers(0, 6)))  # ties: insertion order decides
    return g


@pytest.mark.parametrize("which", ["minimum_spanning_forest", "maximum_spanning_forest",
                                   "minimum_spanning_tree", "maximum_spanning_tree"])
def test_spanning_trees_match_jax(which):
    for seed in range(3):
        ref = getattr(ju, which)(_random_graph(ju, seed))
        got = getattr(tu, which)(_random_graph(tu, seed))
        assert [(e.a, e.b, e.cost) for e in got.edges] == [(e.a, e.b, e.cost) for e in ref.edges]
    g = tu.create_graph([tu.Edge("a", "b", 1.0), tu.Edge("b", "c", 2.0)])
    assert tu.compute_vertices(g.edges) == {"a", "b", "c"} == g.vertices()
    assert tu.minimum_spanning_tree(tu.Graph()).edges == []


def _datasets():
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 10, 6))
    y = np.sin(x)
    var = rng.uniform(0.01, 0.1, 6)
    meta = {"site": "alpha"}
    jd = ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y), variance=jnp.asarray(var), metadata=meta)
    td = pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y), variance=torch.as_tensor(var),
                                     metadata=meta)
    X2 = rng.standard_normal((4, 2))
    jd2 = ab.RegressionDataset.create(jnp.asarray(X2), jnp.asarray(X2[:, 0]), metadata={"site": "beta", "k": "1"})
    td2 = pt.RegressionDataset.create(torch.as_tensor(X2), torch.as_tensor(X2[:, 0]),
                                      metadata={"site": "beta", "k": "1"})
    mean, pvar = rng.standard_normal(6), rng.uniform(0.1, 1.0, 6)
    jp = ab.MarginalDistribution(jnp.asarray(mean), jnp.asarray(pvar))
    tp = pt.MarginalDistribution(torch.as_tensor(mean), torch.as_tensor(pvar))
    return (jd, td), (jd2, td2), (jp, tp)


def _csv_text(module, *args, **kwargs):
    stream = io.StringIO()
    module.write_to_csv(stream, *args, **kwargs)
    return stream.getvalue()


def test_csv_text_matches_jax():
    (jd, td), (jd2, td2), (jp, tp) = _datasets()
    assert _csv_text(tu, td) == _csv_text(ju, jd)
    assert _csv_text(tu, td, tp) == _csv_text(ju, jd, jp)
    assert _csv_text(tu, [td, td2]) == _csv_text(ju, [jd, jd2])
    raw = np.arange(6.0).reshape(3, 2)
    assert _csv_text(tu, torch.as_tensor(raw)) == _csv_text(ju, jnp.asarray(raw))

    def to_map(row):
        return {"x": f"{float(row):.3f}", "tag": "t"}

    assert _csv_text(tu, td, to_map=to_map) == _csv_text(ju, jd, to_map=to_map)
    with pytest.raises(ValueError, match="prediction sets"):
        tu.write_to_csv(io.StringIO(), [td, td2], [tp])
    with pytest.raises(TypeError, match="2-D array"):
        tu.write_to_csv(io.StringIO(), torch.zeros(3))


def test_csv_round_trip_and_both_readers(tmp_path):
    _, _, (jp, tp) = _datasets()
    x = torch.linspace(0, 5, 6, dtype=torch.float64)
    td = pt.RegressionDataset.create(x, torch.sin(x), variance=torch.full((6,), 0.01, dtype=torch.float64))
    path = str(tmp_path / "out.csv")
    tu.write_to_csv(path, td, tp)
    restored = tu.read_csv_dataset(path, ["feature"], "target", "target_variance", device="cpu")
    assert torch.equal(restored.features, td.features) and torch.equal(restored.targets.mean, td.targets.mean)
    assert torch.equal(restored.targets.variance, td.targets.variance)
    native = tu.read_csv_columns(path)
    python = tu.csv._read_csv_python(path)
    assert native.keys() == python.keys() == ju.read_csv_columns(path).keys()
    for name in python:
        np.testing.assert_array_equal(native[name], python[name])


def test_native_library_matches_jax_and_builds_apart(tmp_path):
    path = str(tmp_path / "native.csv")
    with open(path, "w") as f:
        f.write("a,b,c\n1.0,2.5,-3e2\n4,5,6\n")
    got, ref = tnative.parse_csv(path), jnative.parse_csv(path)
    assert got.keys() == ref.keys()
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name])
    rng = np.random.default_rng(0)
    a = rng.integers(0, 30, 120)
    b = (a + 1 + rng.integers(0, 29, 120)) % 30
    cost = rng.uniform(0, 1, 120)
    np.testing.assert_array_equal(tnative.mst_kruskal(a, b, cost), jnative.mst_kruskal(a, b, cost))
    built = list(tnative.BUILD_DIR.glob("libalbatross_native-*.so"))
    assert built and not list(tnative._SOURCE.parent.glob("*.so"))  # never beside the source
    with pytest.raises(IOError):
        tnative.parse_csv(str(tmp_path / "missing.csv"))


def test_random_utilities_given_the_same_draws():
    values = list("abcdefghij")
    assert tu.random_without_replacement(values, 4, np.random.default_rng(3)) == ju.random_without_replacement(
        values, 4, np.random.default_rng(3))
    key = jax.random.PRNGKey(5)
    k_q, k_d = jax.random.split(key)
    A = np.array(jax.random.normal(k_q, (6, 6), jnp.float64))
    eigs = np.array(jax.random.uniform(k_d, (6,), jnp.float64, 0.1, 1.0))
    got = tu.random_covariance_matrix(None, 6, torch.float64, normals=A, eigenvalues=eigs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ju.random_covariance_matrix(key, 6, jnp.float64)),
                               rtol=1e-10, atol=TOL)
    drawn = tu.random_covariance_matrix(7, 6, torch.float64)
    assert torch.allclose(drawn, drawn.T) and torch.linalg.eigvalsh(drawn).min() > 0.09
    cov = np.asarray([[2.0, 0.6], [0.6, 1.0]])
    jdist = ab.JointDistribution.create([1.0, -1.0], cov)
    tdist = pt.JointDistribution(torch.tensor([1.0, -1.0], dtype=torch.float64), torch.as_tensor(cov))
    for k in (1, 5):
        z = np.array(jax.random.normal(key, (2, k), jnp.float64))
        np.testing.assert_allclose(tu.sample_mvn(None, tdist, k, normals=z).numpy(),
                                   np.asarray(ju.sample_mvn(key, jdist, k)), rtol=TOL)
    samples = tu.sample_mvn(0, tdist, 20000).numpy()
    np.testing.assert_allclose(samples.mean(0), [1.0, -1.0], atol=0.05)
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.08)


def test_profiling_helpers(tmp_path):
    @tu.named_scope("decorated_region")
    def work(x):
        return x * 2

    with tu.trace(str(tmp_path / "prof")):
        with tu.named_scope("context_region"):
            work(torch.ones(4)).sum()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"context_region", "decorated_region"} <= names
    results = {}
    with tu.wall_timer("nap", results):
        time.sleep(0.01)
    assert results["nap"] >= 0.01
