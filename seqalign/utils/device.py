"""What a measurement on the GPU prints beside every number."""

from __future__ import annotations

import subprocess


def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.splitlines()[0].strip()


def require_gpu(what: str):
    """The JAX devices, after checking that JAX's backend is a GPU.

    Raises SystemExit(2) otherwise: a measurement never falls back to the
    CPU.
    """
    import sys

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"{what} needs a GPU; JAX's backend is {backend!r}",
              file=sys.stderr)
        raise SystemExit(2)
    return jax.devices()
