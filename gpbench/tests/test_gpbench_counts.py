"""counts.py against values worked by hand."""

import pytest

from gpbench import counts


def test_nlml_flops_at_the_exact_cell():
    n = 28672
    # 28672 = 7 * 4096: 343 * 4096^3 / 3 = 7856926840149.33, plus 9 * 28672^2 = 7398752256
    assert counts.nlml_flops(n) == pytest.approx(7864325592405.333, rel=1e-15)
    assert counts.exact_value_grad_flops(n) == pytest.approx(3 * 7864325592405.333, rel=1e-15)


def test_step_counts():
    assert counts.loo_value_grad_flops(3) == 3 * (2 * 27 / 3 + 9)
    # FITC: 3 (2 m^2 (n + m) - 2 m^3 / 3 + m^3 / 3) at n = 6, m = 3
    assert counts.fitc_value_grad_flops(6, 3) == pytest.approx(3 * (2 * 9 * 9 - 18 + 9))
    assert counts.predict_flops(28672, 4096) == 28672**2 * 4096 + 2 * 28672 * 4096


def test_rooflines():
    # the (28672, 28672) training covariance with its diagonal, f32: bytes bound
    nbytes, flops = counts.gram_bytes_flops(28672, 28672, 1, 4, square=True, diag=True)
    assert nbytes == 4 * (28672**2 + 28672 + 28672)
    assert flops == 28672**2 * 7
    seconds, by = counts.roofline_s(nbytes, flops)
    assert by == "bytes" and seconds == pytest.approx(nbytes / 3.35e12)
    # the panel at b = 1024: 12 MiB moved, 2/3 GFLOP; bytes bound, 12582912 / 3.35e12 s
    nbytes, flops = counts.panel_bytes_flops(1024)
    assert (nbytes, flops) == (12 * 1024**2, 2 * 1024**3 / 3)
    assert counts.roofline_s(nbytes, flops)[0] == pytest.approx(3.7561e-6, rel=1e-4)
    # operations bound past 148 FLOP a byte
    assert counts.roofline_s(1.0, 1e6)[1] == "operations"
