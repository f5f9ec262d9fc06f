"""Compare two programs' printed text line by line: the words equal, each
number equal at its printed digits or one unit of its last digit apart.

Shared by the port's example and tutorial parity tests
(tests/test_torch_examples*.py, tests/test_torch_tutorials.py); holds no
test of its own.
"""

import re
from decimal import Decimal

NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _unit(text: str) -> Decimal:
    """One unit of the last printed digit of ``text``."""
    mantissa, _, exponent = text.lower().partition("e")
    decimals = len(mantissa.partition(".")[2])
    return Decimal(1).scaleb(-decimals + (int(exponent) if exponent else 0))


def numbers(line: str) -> list:
    return [float(m) for m in NUMBER.findall(line)]


def assert_same_print(expected: str, got: str, noise=None, skip=()) -> None:
    """``got`` prints what ``expected`` does.  ``noise`` maps a line index
    to a bound: a number of that line below the bound on either side is a
    rounding residue (an update against a refit, say), held below the
    bound on both sides instead of digit for digit.  Lines in ``skip`` are
    left to the caller."""
    noise = noise or {}
    want, have = expected.splitlines(), got.splitlines()
    assert len(want) == len(have), (want, have)
    for i, (a, b) in enumerate(zip(want, have)):
        if i in skip:
            continue
        assert NUMBER.sub("#", a) == NUMBER.sub("#", b), (i, a, b)
        for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)):
            if i in noise and min(abs(float(x)), abs(float(y))) <= noise[i]:
                assert max(abs(float(x)), abs(float(y))) <= noise[i], (i, a, b)
            else:
                assert abs(Decimal(x) - Decimal(y)) <= max(_unit(x), _unit(y)), (i, a, b)
