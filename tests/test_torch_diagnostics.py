"""Port parity of ops/diagnostics.py: the eigen-direction text.

The same f64 matrices (distinct eigenvalues well above eps |A|, so each
eigenvector is fixed up to its sign and each printed digit is stable) go
through both packages.  LAPACK may return either sign of an eigenvector,
and the two packages' eigh need not agree on it, so the texts are compared
with each index line's sign read relative to the first listed entry of its
eigenvector (its largest); every other character must match.
"""

import io
import re

import numpy as np
import pytest
import torch

from albatross_tpu.ops import diagnostics as jd
from albatross_tpu_torch.ops import diagnostics as td

torch.set_num_threads(2)


def _matrix(n, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    vals = np.sort(rng.uniform(0.1, 10.0, n))
    vals[:2] = [1e-3, 3e-3]  # small directions, as the diagnostics target; well above eps * |A|
    A = Q @ np.diag(vals) @ Q.T
    return A + 1e-12 * rng.standard_normal((n, n))  # not exactly symmetric: both take sym(A)


def _signless(text):
    """Each eigenvector's entries signed relative to its first (largest)
    entry, so a flipped eigenvector reads the same."""
    out, first = [], None
    for line in text.splitlines():
        m = re.match(r"    index (\d+): ([+-])(\S+)", line)
        if not m:
            out.append(line)
            first = None
            continue
        if first is None:
            first = m.group(2)
        out.append(f"    index {m.group(1)}: {'same' if m.group(2) == first else 'flip'} {m.group(3)}")
    return out


@pytest.mark.parametrize("which", ["small", "large"])
@pytest.mark.parametrize("n,k,top", [(12, 3, 5), (40, 5, 8)])
def test_eigen_direction_text_matches_jax(which, n, k, top):
    A = _matrix(n, n + k)
    jfn = getattr(jd, f"print_{which}_eigen_directions")
    tfn = getattr(td, f"print_{which}_eigen_directions")
    ref = jfn(A, k=k, top_entries=top)
    stream = io.StringIO()
    got = tfn(torch.tensor(A), k=k, top_entries=top, stream=stream)
    assert stream.getvalue() == got
    assert _signless(got) == _signless(ref)
    assert len(got.splitlines()) == k * (top + 1)
    kind = "smallest" if which == "small" else "largest"
    assert got.startswith(f"{kind} eigenvalue #0: ")
