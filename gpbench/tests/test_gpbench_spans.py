"""The port spans' reducer (``gpbench/spans.py``) on synthetic profiler
rows: launches to spans by correlation id and thread, backward nodes to
their forward span by sequence number, the card's mirrors of host labels
dropped, idle gaps to the span over their middle or outside the port, and
every figure a step."""

import time

import pytest
import torch

from conftest import tiny_cell
from gpbench import run, spans
from gpbench.spans import LABEL, Row

LL, CHOL, TRAIL = "albatross.gp.log_likelihood", "albatross.cholesky", "albatross.cholesky.trailing"
MAIN, AUTOGRAD = 1, 2


def host(name, start, end, thread=MAIN, activity="cpu_op", seq=-1, fwd_thread=0, corr=0, linked=0):
    return Row(name, activity, start, end, thread, seq, fwd_thread, corr, linked, False)


def card(name, start, end, corr=0, linked=0, activity="gpu_op"):
    return Row(name, activity, start, end, 0, -1, 0, corr, linked, True)


def runtime(start, corr, thread=MAIN):
    return host("cudaLaunchKernel", start, start + 2, thread, activity="cuda_runtime", corr=corr)


def step_rows():
    """Two steps of the NLML root over [0, 1000] ns; the card runs k1 from
    the trailing update, k2 from a backward node whose forward mm ran in
    the factorization, k3 from a span inside that node (linked by its own
    correlation id only) and a copy outside every span."""
    return [
        host(LABEL, 0, 1000, activity="user_annotation"),
        host(LL, 10, 500, activity="user_annotation"),
        host("albatross.gp.predict", 30, 40, activity="user_annotation"),  # a root inside a root: no step
        host(CHOL, 20, 300, activity="user_annotation"),
        host(TRAIL, 50, 120, activity="user_annotation"),
        runtime(60, corr=11),
        host("aten::mm", 5, 8, seq=7),  # the same number before the node's op: not its forward
        host("aten::matmul", 148, 162, seq=7),
        host("aten::mm", 150, 160, seq=7),  # the node's forward op, in the factorization
        host(LL, 510, 590, activity="user_annotation"),
        host("autograd::engine::evaluate_function: MmBackward0", 600, 850, AUTOGRAD, seq=7, fwd_thread=MAIN),
        host("aten::add", 610, 615, seq=7),  # after the node started: not its forward
        runtime(610, corr=12, thread=AUTOGRAD),
        host(TRAIL, 630, 650, AUTOGRAD, activity="user_annotation"),
        runtime(640, corr=14, thread=AUTOGRAD),
        runtime(890, corr=13),
        card("sm90_gemm", 200, 260, corr=11, linked=11),
        card("sm90_gemm_bwd", 620, 680, corr=12, linked=11),  # a linked id that is another call's number
        card("elementwise", 690, 700, corr=14),
        card("Memcpy DtoH (Device -> Pageable)", 900, 950, corr=13, linked=13, ),
        card(CHOL, 20, 300, activity="gpu_user_annotation"),  # mirrors of host labels
        card("an annotation", 0, 1000, activity="gpu_user_annotation"),
        card(LABEL, 0, 1000),
    ]


@pytest.fixture
def summary():
    return spans.summarise(step_rows())


def test_launches_follow_their_runtime_call_and_backward_lineage(summary):
    stacks = summary["stacks"]
    assert stacks[(LL, CHOL, TRAIL)][:2] == [pytest.approx(70e-9), 2]  # k1, and k3 by correlation id
    assert stacks[(LL, CHOL)][:2] == [pytest.approx(60e-9), 1]  # k2 through sequence number 7
    assert stacks[()][:2] == [pytest.approx(50e-9), 0]  # the copy: device time, no launch
    assert summary["outside"] == [(("Memcpy DtoH (Device -> Pageable)", "no host op"), pytest.approx(50e-9))]


def test_mirrors_are_neither_busy_nor_launches(summary):
    assert summary["busy_s"] == pytest.approx(180e-9)
    assert summary["device_s"] == pytest.approx(180e-9)
    assert summary["launches"] == 3


def test_idle_gaps_go_to_the_span_over_their_middle(summary):
    stacks = summary["stacks"]
    assert stacks[(LL, CHOL, TRAIL)][2] == pytest.approx(200e-9)  # [0, 200], middle 100
    assert stacks[(LL,)][2] == pytest.approx(360e-9)  # [260, 620]
    assert stacks[(LL, CHOL)][2] == pytest.approx(210e-9)  # [680, 690] and [700, 900], in the node
    assert stacks[()][2] == pytest.approx(50e-9)  # [950, 1000]: outside the port


def test_figures_are_per_root_span(summary):
    assert summary["steps"] == 2
    assert spans.device_ms(summary, CHOL) == pytest.approx(130e-9 / 2 * 1e3)
    assert spans.device_ms(summary, TRAIL) == pytest.approx(70e-9 / 2 * 1e3)
    assert spans.launches(summary, CHOL) == pytest.approx(1.5)
    assert spans.port_idle_ms(summary) == pytest.approx(770e-9 / 2 * 1e3)
    assert spans.device_ms(summary, "albatross.sparse.qr") is None  # never opened
    table = {row[0]: row[1:] for row in spans.table(summary)}
    assert table[LL] == pytest.approx((130e-9 / 2 * 1e3, 1.5, 770e-9 / 2 * 1e3))
    assert table[spans.OUTSIDE] == pytest.approx((50e-9 / 2 * 1e3, 0.0, 50e-9 / 2 * 1e3))


def test_a_node_no_op_recorded_goes_to_the_op_before_it():
    """A ``CopySlices`` node takes a sequence number that no forward op
    recorded: it joins the last op with the nearest smaller number."""
    rows = [host(LABEL, 0, 1000, activity="user_annotation"), host(LL, 10, 500, activity="user_annotation"),
            host("aten::add", 30, 40, seq=3), host(CHOL, 100, 300, activity="user_annotation"),
            host("aten::copy_", 200, 210, seq=8),
            host("autograd::engine::evaluate_function: torch::autograd::CopySlices", 600, 700, AUTOGRAD, seq=9,
                 fwd_thread=MAIN),
            runtime(610, corr=21, thread=AUTOGRAD), card("Memcpy DtoD (Device -> Device)", 620, 680, corr=21)]
    assert spans.summarise(rows)["stacks"][(LL, CHOL)][0] == pytest.approx(60e-9)


def test_no_label_raises():
    with pytest.raises(RuntimeError):
        spans.summarise([row for row in step_rows() if row.name != LABEL])


def test_readers_read_nothing_off_the_card():
    """A traced CPU run reports none of the span metrics and raises nothing."""
    cell = tiny_cell("exact_se1d.tune")
    result = run.run_cell(cell, 2**31 + 5, 0.5, True, "cpu", time.perf_counter())[0]
    assert result["correct"] is True
    assert {"factor_ms.tune", "trailing_ms.tune", "port_idle_ms.tune"} <= {m["name"] for m in cell.per_layer}
    assert result["metrics"] == {}


def test_rows_tell_the_kind_as_kineto_does():
    """A small CPU step with the port's spans on: the kind ``rows`` tells
    from each row is the one Kineto gives (where this torch's events carry
    ``activity_type``), and the reducer finds the root span."""
    import albatross_tpu_torch as pt
    from albatross_tpu_torch.utils.profiling import spans as port_spans
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.linspace(0.0, 10.0, 64, dtype=torch.float64)
    fit = pt.gp_from_covariance(pt.SquaredExponential(0.5, 1.0)).fit(pt.RegressionDataset.create(x, torch.sin(x)))
    with profile(activities=[ProfilerActivity.CPU]) as prof, port_spans(), record_function(LABEL):
        fit.predict(x[::4]).marginal()
    events = list(prof.profiler.kineto_results.events())
    found = spans.rows(events)
    assert {r.activity for r in found} == {"cpu_op", "user_annotation"}
    if hasattr(events[0], "activity_type"):
        assert [r.activity for r in found] == [e.activity_type() for e in events]
    assert spans.summarise(found)["steps"] == 1
