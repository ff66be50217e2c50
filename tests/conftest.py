"""Test configuration: run on CPU with 8 virtual devices.

Sharding tests need a multi-device mesh, so multi-device code paths are
validated on a virtual CPU mesh. JAX_PLATFORMS defaults to ``cpu``; the
GPU-marked tests run on the card with ``JAX_PLATFORMS=cuda`` (see
tests/test_gpu.py). Must be set before JAX initializes.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest

from seqalign.models import ScoringModel, load_builtin


def pytest_collection_modifyitems(items):
    """Every test not marked ``slow`` is the fast tier: ``pytest -m fast``
    is the per-commit set (<60 s), the full suite (incl. the differential
    matrix and 2-process multihost tests) is the nightly set."""
    for item in items:
        if item.get_closest_marker("slow") is None:
            item.add_marker(pytest.mark.fast)


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is a GPU (decided at run time, never at
    collection, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on the card")


@pytest.fixture
def cuda_standin(monkeypatch):
    """Run the CUDA engine's wrapper on CPU with the kernel replaced by its
    NumPy model of the same loop nest (swa_cuda.reference_kernel)."""
    import functools

    from seqalign.ops import swa_cuda

    monkeypatch.setattr(
        swa_cuda, "compile_kernel",
        lambda *a, go, ge: functools.partial(
            swa_cuda.reference_kernel, go=go, ge=ge
        ),
    )


@pytest.fixture(scope="session")
def blosum62():
    return load_builtin(
        "BLOSUM62",
        ScoringModel(gap_open=-2, gap_extend=-1, use_match_mismatch=False),
    )


@pytest.fixture(scope="session")
def pam250():
    return load_builtin(
        "PAM250",
        ScoringModel(gap_open=-2, gap_extend=-1, use_match_mismatch=False),
    )


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def random_protein(rng, length):
    """Random residues drawn from the 20 standard amino acids."""
    aas = "ACDEFGHIKLMNPQRSTVWY"
    return "".join(aas[i] for i in rng.integers(0, len(aas), size=length))
