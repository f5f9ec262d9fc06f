"""Port parity of serialize/: checkpoints, parameter JSON, compression.

Checkpoints are the port's own format: a model, a fit (its predictions
equal before and after, exactly), a sampler chain and a RANSAC output
round-trip, with dtypes kept; the restricted loader refuses classes from
outside the allowed modules, a newer version and another package's magic
(in both directions).  Parameter JSON is the same text as the JAX
package's for the same store, and compression the same bytes.
"""

import io
import pickle
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu import serialize as jser
from albatross_tpu_torch import serialize as tser
from albatross_tpu_torch.convert import params_from_numpy
from albatross_tpu_torch.samplers import ensemble_sampler
from albatross_tpu_torch.serialize import checkpoint as tck

torch.set_num_threads(2)
# PyTorch's CPU f32 exp can return ~1e-4-wrong values on its first
# multi-threaded call; one warm-up call takes that call out of the tests.
torch.exp(torch.zeros(1 << 16))


def _model_and_data(n=30, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    kernel = pt.SquaredExponential(1.5, 1.2) + pt.measurement_only(pt.IndependentNoise(0.2))
    kernel = kernel.set_param_prior("squared_exponential_length_scale", pt.LogScaleUniformPrior(1e-2, 1e2))
    data = pt.RegressionDataset.create(torch.as_tensor(x, dtype=dtype), torch.as_tensor(y, dtype=dtype))
    return pt.gp_from_covariance(kernel, jitter=1e-6), data


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fit_model_round_trip(tmp_path, dtype):
    model, data = _model_and_data(dtype=dtype)
    fit = model.fit(data)
    xs = torch.linspace(0, 10, 17, dtype=dtype)
    before = fit.predict(xs).joint()
    path = str(tmp_path / "fit.ckpt")
    tser.save_checkpoint(path, fit)
    restored = tser.load_checkpoint(path, device="cpu")
    after = restored.predict(xs).joint()
    assert after.mean.dtype == dtype
    assert torch.equal(after.mean, before.mean) and torch.equal(after.covariance, before.covariance)
    assert restored.model.get_params().keys() == model.get_params().keys()


def test_model_round_trip_keeps_params_priors_and_likelihood(tmp_path):
    model, data = _model_and_data()
    path = str(tmp_path / "model.ckpt")
    tser.save_checkpoint(path, model)
    restored = tser.load_checkpoint(path, device="cpu")
    assert restored.pretty_params() == model.pretty_params()
    assert pt.core.pretty_priors(restored.get_params()) == pt.core.pretty_priors(model.get_params())
    assert float(restored.log_likelihood(data)) == float(model.log_likelihood(data))


def test_chain_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    chain = ensemble_sampler(lambda x: -0.5 * (x * x).sum(-1), torch.as_tensor(rng.standard_normal((6, 2))), 5,
                             key=1)
    path = str(tmp_path / "chain.ckpt")
    tser.save_checkpoint(path, chain)
    restored = tser.load_checkpoint(path)  # numpy only: no device is needed
    for name in ("params", "log_prob", "accepted"):
        got, ref = getattr(restored, name), getattr(chain, name)
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert restored.acceptance_rate() == chain.acceptance_rate()


def test_ransac_output_round_trip(tmp_path):
    rng = np.random.default_rng(2012)
    x = np.sort(rng.uniform(0.0, 10.0, 20))
    y = np.sin(x) + 0.05 * rng.standard_normal(20)
    y[[3, 11]] += 4.0
    data = pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y),
                                       variance=torch.full((20,), 0.0025, dtype=torch.float64))
    model = pt.gp_from_covariance(pt.SquaredExponential(1.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.1)))
    fit = model.ransac(pt.models.DefaultGPRansacStrategy(), pt.RansacConfig(1.0, 3, 10, 6, 6)).fit(data)
    path = str(tmp_path / "ransac.ckpt")
    tser.save_checkpoint(path, fit)
    restored = tser.load_checkpoint(path, device="cpu")
    out, ref = restored.fit.ransac_output, fit.fit.ransac_output
    assert out.return_code == ref.return_code
    assert out.best.inliers == ref.best.inliers and out.best.outliers == ref.best.outliers
    assert len(out.iterations) == len(ref.iterations)
    xs = torch.linspace(0, 10, 7, dtype=torch.float64)
    assert torch.equal(restored.predict(xs).mean(), fit.predict(xs).mean())


def test_shared_tensors_stay_shared(tmp_path):
    t = torch.arange(5.0)
    path = str(tmp_path / "shared.ckpt")
    tser.save_checkpoint(path, {"a": t, "b": [t, np.arange(3)], "n": np.float64(2.5), "d": torch.float32})
    out = tser.load_checkpoint(path, device="cpu")
    assert out["a"] is out["b"][0] and torch.equal(out["a"], t)
    np.testing.assert_array_equal(out["b"][1], np.arange(3))
    assert out["n"] == 2.5 and out["d"] is torch.float32


def test_tensors_go_to_the_card_unless_the_cpu_is_asked(tmp_path, monkeypatch):
    path = str(tmp_path / "t.ckpt")
    tser.save_checkpoint(path, torch.ones(3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tser.load_checkpoint(path)
    assert tser.load_checkpoint(path, device="cpu").device.type == "cpu"


class _NotAllowed:
    pass


def test_loader_refuses_classes_from_outside(tmp_path):
    path = str(tmp_path / "bad.ckpt")
    tser.save_checkpoint(path, _NotAllowed())  # a class of this test module
    with pytest.raises(pickle.UnpicklingError, match="disallowed"):
        tser.load_checkpoint(path, device="cpu")
    graph = pickle.dumps(__import__("os").getcwd)  # a callable the loader must not resolve
    arrays = io.BytesIO()
    np.savez(arrays)
    with open(path, "wb") as f:
        f.write(tck.MAGIC)
        pickle.dump({"version": 1, "objects": graph, "arrays": zlib.compress(arrays.getvalue())}, f)
    with pytest.raises(pickle.UnpicklingError, match="disallowed"):
        tser.load_checkpoint(path, device="cpu")


def _global_pickle(module: str, name: str) -> bytes:
    """A protocol-4 pickle of the one global ``module.name`` (a dotted name
    walks attributes, as pickle resolves nested classes)."""
    def text(t):
        return b"\x8c" + bytes([len(t.encode())]) + t.encode()
    return b"\x80\x04" + text(module) + text(name) + b"\x93."


@pytest.mark.parametrize("module, name", [
    ("builtins", "eval"), ("builtins", "exec"), ("builtins", "getattr"), ("builtins", "__import__"),
    ("numpy", "load"), ("functools", "reduce"), ("collections", "namedtuple"),
    ("albatross_tpu_torch.serialize.checkpoint", "save_checkpoint"),  # a port function
    ("albatross_tpu_torch.serialize.checkpoint", "pickle.loads"),  # through a module the port imports
    ("albatross_tpu_torch.serialize.checkpoint", "io.BytesIO"),  # a class that is not the port's
])
def test_loader_refuses_functions_and_foreign_names(tmp_path, module, name):
    """Each name a crafted checkpoint could call to run code is refused
    when the graph is loaded, before anything is called."""
    arrays = io.BytesIO()
    np.savez(arrays)
    path = str(tmp_path / "crafted.ckpt")
    with open(path, "wb") as f:
        f.write(tck.MAGIC)
        pickle.dump({"version": 1, "objects": _global_pickle(module, name),
                     "arrays": zlib.compress(arrays.getvalue())}, f)
    with pytest.raises(pickle.UnpicklingError, match="disallowed"):
        tser.load_checkpoint(path, device="cpu")


def test_loader_admits_the_listed_data_types(tmp_path):
    """The builtin, collections and functools data types on the list round-trip."""
    import collections
    import functools

    obj = {"s": {1, 2}, "f": frozenset({3}), "sl": slice(1, 5, 2), "c": 1 + 2j, "r": range(3),
           "ba": bytearray(b"ab"), "od": collections.OrderedDict(a=1), "dd": collections.defaultdict(list, a=[1]),
           "dq": collections.deque([1, 2]), "p": functools.partial(pt.RegressionDataset, None)}
    path = str(tmp_path / "data.ckpt")
    tser.save_checkpoint(path, obj)
    back = tser.load_checkpoint(path, device="cpu")
    assert {k: v for k, v in back.items() if k != "p"} == {k: v for k, v in obj.items() if k != "p"}
    assert back["p"].func is pt.RegressionDataset and back["p"].args == (None,)


def test_newer_version_fails_at_the_gate(tmp_path):
    path = str(tmp_path / "new.ckpt")
    tser.save_checkpoint(path, {"x": 1})
    with open(path, "rb") as f:
        f.read(len(tck.MAGIC))
        payload = pickle.load(f)
    payload["version"] = tser.SERIALIZATION_VERSION + 1
    with open(path, "wb") as f:
        f.write(tck.MAGIC)
        pickle.dump(payload, f)
    with pytest.raises(ValueError, match="newer than supported"):
        tser.load_checkpoint(path, device="cpu")


def test_each_package_refuses_the_others_checkpoints(tmp_path):
    jax_path, port_path = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jser.save_checkpoint(jax_path, {"x": jnp.ones(3)})
    tser.save_checkpoint(port_path, {"x": torch.ones(3)})
    with pytest.raises(ValueError, match="JAX package"):
        tser.load_checkpoint(jax_path, device="cpu")
    with pytest.raises(ValueError, match="not an albatross_tpu checkpoint"):
        jser.load_checkpoint(port_path)
    with open(str(tmp_path / "junk"), "wb") as f:
        f.write(b"garbage!" * 4)
    with pytest.raises(ValueError, match="not an albatross_tpu_torch checkpoint"):
        tser.load_checkpoint(str(tmp_path / "junk"), device="cpu")


def _param_stores():
    jk = ab.SquaredExponential(1.5, 1.2) + ab.measurement_only(ab.IndependentNoise(0.2)) + ab.Matern32(0.7, 0.3)
    jk = jk.set_param_prior("squared_exponential_length_scale", ab.core.LogScaleUniformPrior(1e-2, 1e2))
    jk = jk.set_param_prior("sigma_independent_noise", ab.core.GaussianPrior(0.2, 0.05))
    jk = jk.set_param_prior("matern_32_length_scale", ab.core.UniformPrior(0.1, 3.0))
    jk = jk.set_param_prior("sigma_matern_32", ab.core.FixedPrior())
    tk = pt.SquaredExponential() + pt.measurement_only(pt.IndependentNoise()) + pt.Matern32()
    tk = tk.set_param_prior("squared_exponential_length_scale", pt.LogScaleUniformPrior(1e-2, 1e2))
    tk = tk.set_param_prior("sigma_independent_noise", pt.GaussianPrior(0.2, 0.05))
    tk = tk.set_param_prior("matern_32_length_scale", pt.UniformPrior(0.1, 3.0))
    tk = tk.set_param_prior("sigma_matern_32", pt.FixedPrior())
    tk = params_from_numpy(tk, {k: np.asarray(p.value) for k, p in jk.get_params().items()})
    return jk.get_params(), tk.get_params()


def test_params_json_is_the_same_text_in_both_packages(tmp_path):
    jp, tp = _param_stores()
    text = tser.params_to_json(tp)
    assert text == jser.params_to_json(jp)
    assert tser.params_to_dict(tp) == jser.params_to_dict(jp)
    back = tser.params_from_json(jser.params_to_json(jp))  # the port reads the JAX package's file
    assert tser.params_to_json(back) == text
    assert jser.params_to_json(jser.params_from_json(text)) == text  # and the reverse
    path = str(tmp_path / "params.json")
    tser.save_params(path, pt.gp_from_covariance(pt.SquaredExponential()))
    assert tser.load_params(path).keys() == {"squared_exponential_length_scale", "sigma_squared_exponential"}
    for prior in tp.values():
        assert tser.prior_from_dict(tser.prior_to_dict(prior.prior)) == prior.prior


def test_compression_bytes_equal_the_jax_packages():
    payload = "albatross " * 200
    for level in (0, 3, 9, 20):
        assert tser.compress(payload, level) == jser.compress(payload, level)
    blob = tser.compress(payload)
    assert tser.decompress(blob, as_text=True) == payload
    assert tser.decompress(blob) == payload.encode()
    with pytest.raises(ValueError, match="empty"):
        tser.decompress(b"")
    with pytest.raises(ValueError, match="error determining"):
        tser.decompress(b"not zlib")
    assert tser.maybe_decompress(b"not zlib") == (False, None)
    assert tser.maybe_decompress(blob, as_text=True) == (True, payload)
    assert io.BytesIO(blob).read() == jser.compress(payload)
