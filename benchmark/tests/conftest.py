"""Fixtures of the benchmark's tests: one tiny copy of the benchmark a
session (tiny.py)."""

import pytest

from benchmark.tests.tiny import make_copy


@pytest.fixture(scope="session")
def tiny_copy(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("bench"))
