"""The port's layer spans (``albatross_tpu_torch.utils.profiling``): off,
they record nothing and create no ``RecordFunction``; on (``spans()``,
``trace()``), the NLML, FITC, leave-one-out, predict and temperature-model
steps open the ``albatross.*`` spans with their stated nesting, and the
port's autograd Functions open their forward's span in their backward.
The composed covariance opens ``albatross.covariance`` once an evaluation
and ``albatross.covariance.metric`` once a non-Euclidean radial term, and
the backward of its plain torch ops belongs to it by sequence number
(``gpbench/spans.py``'s rule)."""

import contextlib
import importlib
import json
import threading

import numpy as np
import pytest
import torch

import albatross_tpu_torch as pt
from albatross_tpu_torch import config
from albatross_tpu_torch import temperature as ttemp
from albatross_tpu_torch.evaluation import LeaveOneOutLikelihood
from albatross_tpu_torch.utils import profiling
from gpbench import spans as reducer

rg = importlib.import_module("albatross_tpu_torch.ops.radial_gram")

torch.set_num_threads(2)

BACKWARD = "autograd::engine::evaluate_function: "
LL = "albatross.gp.log_likelihood"
CHOL = "albatross.cholesky"
COV = "albatross.covariance"
METRIC = "albatross.covariance.metric"


def _data(n: int, seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    x = torch.sort(torch.rand(n, dtype=torch.float64, generator=g) * 100.0).values
    y = torch.sin(0.3 * x) + 0.1 * torch.randn(n, dtype=torch.float64, generator=g)
    return pt.RegressionDataset.create(x, y)


def _kernel(length_scale: float = 0.5):
    return pt.SquaredExponential(length_scale, 1.0) + pt.measurement_only(
        pt.IndependentNoise(0.3, assume_unique=True))


def _value_grad(model, objective, data):
    x = model.get_tunable_parameters().values.clone().requires_grad_(True)
    value = objective(model.set_tunable_params(x), data)
    return torch.autograd.grad(value, x)


def _nlml_step():
    """NLML value+grad at N = 2304 in panels of 128: the factorization's
    blocked loop starts above n = 2048."""
    model, data = pt.gp_from_covariance(_kernel(), jitter=1e-4), _data(2304)
    return lambda: _value_grad(model, lambda m, d: -m.log_likelihood(d), data)


def _fitc_step():
    model = pt.sparse_gp_from_covariance(_kernel(2.0), inducing_point_strategy=pt.UniformlySpacedInducingPoints(64))
    data = _data(512)
    return lambda: _value_grad(model, lambda m, d: -m.log_likelihood(d), data)


def _loo_step():
    model, data, metric = pt.gp_from_covariance(_kernel(), jitter=1e-4), _data(384), LeaveOneOutLikelihood()
    return lambda: _value_grad(model, lambda m, d: metric(d, m), data)


def _predict_step():
    fit = pt.gp_from_covariance(_kernel(), jitter=1e-4).fit(_data(384))
    xs = torch.linspace(0.0, 100.0, 64, dtype=torch.float64)
    return lambda: fit.predict(xs).marginal()


def _temperature_step():
    """The upstream temperature model's NLML value+grad over 384 stations
    in float64: its covariance through the DSL, over the angular and the
    radial station metrics."""
    stations, obs, _ = ttemp.synthesize_stations(384, np.random.default_rng(5))
    data = pt.RegressionDataset.create(torch.as_tensor(stations), torch.as_tensor(obs),
                                       variance=torch.ones(384, dtype=torch.float64))
    model = ttemp.build_model()
    return lambda: _value_grad(model, lambda m, d: -m.log_likelihood(d), data)


STEPS = {"nlml": _nlml_step, "fitc": _fitc_step, "loo": _loo_step, "predict": _predict_step,
         "temperature": _temperature_step}

# each span's parents over a step: the innermost enclosing port span or
# backward node on its thread (None for a root)
NESTING = {
    "nlml": {
        LL: {None},
        "albatross.gram": {LL},
        CHOL: {LL, "_ColumnPanelsBackward"},
        "albatross.cholesky.panel": {CHOL, "_PanelCholInvBackward"},
        "albatross.cholesky.panel_solve": {CHOL},
        "albatross.cholesky.trailing": {CHOL, "_TrailingUpdateBackward"},
        "albatross.cholesky.whiten": {CHOL},
    },
    "fitc": {
        "albatross.sparse.log_likelihood": {None},
        "albatross.sparse.components": {"albatross.sparse.log_likelihood"},
        "albatross.gram": {"albatross.sparse.components", COV},  # K_fu, and K_uu through the covariance's call
        COV: {"albatross.sparse.components"},
        CHOL: {"albatross.sparse.components"},
        "albatross.solve": {"albatross.sparse.components", "albatross.sparse.log_likelihood"},
        "albatross.sparse.qr": {"albatross.sparse.log_likelihood"},
    },
    "loo": {
        "albatross.cv.loo": {None},
        "albatross.cv.folds": {"albatross.cv.loo", "albatross.cv.blocks", "albatross.cv.scores"},
        "albatross.gram": {"albatross.cv.loo"},
        CHOL: {"albatross.cv.loo", "albatross.cv.scores"},  # the scores factor each fold's joint
        "albatross.solve": {"albatross.cv.loo", "albatross.cv.scores"},
        "albatross.cv.blocks": {"albatross.cv.loo", "albatross.cv.blocks"},
        "albatross.cholesky.inverse": {"albatross.cv.blocks", "albatross.cholesky.inverse"},
        "albatross.cv.scores": {"albatross.cv.loo"},
    },
    "predict": {
        "albatross.gp.predict": {None},
        "albatross.gram": {"albatross.gp.predict"},
        "albatross.solve": {"albatross.gp.predict"},
        "albatross.solve.whiten": {"albatross.solve"},
    },
    "temperature": {
        LL: {None},
        COV: {LL},
        METRIC: {COV},
        CHOL: {LL},
    },
}


def _profile(step, on: bool) -> list:
    """(name, start, end, thread) of every host event of one step."""
    step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.spans() if on else contextlib.nullcontext():
            step()
    return [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id()) for e in prof.profiler.kineto_results.events()]


def _parents(events) -> dict:
    """Each port span's set of parents: the innermost port span or backward
    node (by its node's name) that encloses it on its thread."""
    frames = [e for e in events if e[0].startswith(("albatross.", BACKWARD))]
    out = {}
    for name, start, end, thread in frames:
        if not name.startswith("albatross."):
            continue
        enclosing = [f for f in frames if f[3] == thread and f[1] <= start and end <= f[2]
                     and (f[1], -f[2]) < (start, -end)]
        parent = max(enclosing, key=lambda f: (f[1], -f[2]))[0] if enclosing else None
        out.setdefault(name, set()).add(parent[len(BACKWARD):] if parent and parent.startswith(BACKWARD) else parent)
    return out


@pytest.fixture
def blocks_of_128():
    before = config.CHOLESKY_BLOCK_SIZE
    config.CHOLESKY_BLOCK_SIZE = 128
    yield
    config.CHOLESKY_BLOCK_SIZE = before


@pytest.mark.parametrize("case", sorted(STEPS))
def test_spans_nest_as_stated(case, blocks_of_128):
    assert _parents(_profile(STEPS[case](), on=True)) == NESTING[case]
    assert not profiling._ON


@pytest.mark.parametrize("case", sorted(STEPS))
def test_spans_off_record_nothing(case, blocks_of_128, monkeypatch):
    """Off, the default: no ``albatross.`` row in the profiler's trace, and
    no ``record_function`` is made."""
    step = STEPS[case]()
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: made.append(a) or real(*a, **k))
    events = _profile(step, on=False)
    assert not [e for e in events if e[0].startswith("albatross.")]
    assert made == []
    with profiling.spans():
        step()
    assert made and all(a[0].startswith("albatross.") for a in made)


def test_the_covariance_spans_open_once_an_evaluation_and_never_in_themselves():
    """One NLML step evaluates the temperature covariance once: one
    ``albatross.covariance``, and inside it one ``albatross.covariance.metric``
    for each of its two non-Euclidean radial terms (angular, radial); no
    covariance span opens inside another."""
    events = _profile(_temperature_step(), on=True)
    covariance = [e for e in events if e[0] == COV]
    metric = [e for e in events if e[0] == METRIC]
    assert len(covariance) == 1 and len(metric) == 2
    for name, start, end, thread in covariance + metric:
        assert not [e for e in events if e[0] == name and e[3] == thread and e[1:3] != (start, end)
                    and e[1] <= start and end <= e[2]]


def test_the_covariance_backward_belongs_to_the_covariance_span():
    """The backward of the composed covariance's plain torch ops (its
    profiles' ``exp``) opens no span; by its forward op's sequence number,
    the benchmark's reducer puts it under ``albatross.covariance``."""
    step = _temperature_step()
    step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.spans():
            step()
    rows = reducer.rows(prof.profiler.kineto_results.events())
    index = reducer._Index([r for r in rows if not r.on_card])
    nodes = [r for r in rows if r.name == BACKWARD + "ExpBackward0"]
    assert len(nodes) == 2  # the angular exponential's and the radial squared exponential's
    for node in nodes:
        assert not [r for r in rows if r.name.startswith("albatross.") and r.thread == node.thread
                    and r.start <= node.start and node.end <= r.end]
        assert COV in index.stack(node.thread, (node.start + node.end) // 2)


def test_gram_function_backward_opens_the_gram_span(monkeypatch):
    """The gram's autograd Function (the card's path; its launch here by the
    plain closed form) opens ``albatross.gram`` in its backward."""
    monkeypatch.setattr(rg, "_launch", lambda X, Y, ls, sigma, diag, profile, counter, cols=None:
                        rg.plain_radial_gram(X, Y, ls, sigma, profile, diag))
    x = torch.linspace(0.0, 10.0, 96, dtype=torch.float64)[:, None]
    ls, sigma = torch.tensor(0.7, dtype=torch.float64, requires_grad=True), torch.tensor(1.3, dtype=torch.float64)

    def step():
        K = rg._RadialGramFunction.apply(x, x, ls, sigma, None, "squared_exponential", 0.7, 1.3, "radial_gram", None)
        return torch.autograd.grad(K.sum(), ls)

    assert _parents(_profile(step, on=True)) == {"albatross.gram": {"_RadialGramFunctionBackward"}}


def test_spans_switch_covers_threads_and_restores(monkeypatch):
    """``spans()`` turns the spans on for every thread, and restores the
    setting it found, nested too."""
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: made.append(a[0]) or real(*a, **k))

    def work():
        with profiling.named_scope("albatross.test.thread"):
            torch.ones(4).sum()

    with profiling.spans():
        thread = threading.Thread(target=work)
        thread.start()
        thread.join(timeout=60)
        assert not thread.is_alive()
        with profiling.spans():
            assert profiling._ON
        assert profiling._ON
    assert not profiling._ON
    work()
    assert made == ["albatross.test.thread"]


def test_trace_writes_the_port_spans(tmp_path):
    step = _predict_step()
    with profiling.trace(str(tmp_path / "prof")):
        step()
    names = {e.get("name") for e in json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]}
    assert {"albatross.gp.predict", "albatross.gram", "albatross.solve"} <= names
    assert not profiling._ON
